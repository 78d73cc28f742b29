#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line; each phase's
seconds on the host clock are printed after it):

  1. print the card (``nvidia-smi`` name and power limit) and build the
     CUDA kernels from ``mpr_tpu_torch/ops/csrc`` (nvcc, first use): the
     main library (every kernel, B, B1, V and D at the shapes their
     pickers take; its seconds are the render path's first-use build) and
     then the extra one (B, B1, V, D and K2 at the other shapes, for
     phases 8b's, 9's and 14's forced shapes, and K2f's first design),
     with ptxas's registers, stack frame and spills for every
     instantiation of A, B, B1, C, C2, C1, V, D, K2f (the walk at every K
     of ``SCAN_SWEEP``, storing or not, and its first design) and K2, each
     with its shape and library (a spill fails the run at its end);
  2. the 2D path: with every launch count set to 0, render the
     ``stress_2d(600)`` model at 1024^2 and ``stress_2d(1500)`` at 2048^2
     through ``mpr_tpu_torch.render.render2d``, recording each kernel's
     inputs; kernels A, C and B must have launched, and each frame must
     have built its tape's dependency schedule for kernel A once (its
     levels, widest level and host build time are printed);
  3. hold each kernel's outputs against its plain PyTorch version called on
     the same CUDA inputs (integers and the 0/1 fill must be equal), and
     each image against ``render2d_brute`` (the full tape at every pixel);
  4. re-render an edited tape with another op set: no new build;
  5. time each kernel, its plain version and the whole frame with CUDA
     events (warm-up, then the median of repeated runs; a frame after the
     first on one tape must build no schedule), each kernel's device time
     with torch.profiler (kernel C's beside its byte bound and its share
     of it), and profile a frame;
  5b. kernel A under a schedule built before the tape's immediates
     changed (as a fit step or a slider would leave it): status and codes
     at three launch shapes must equal the plain version's on the new
     immediates, which must differ from those on the old ones;
  6. the 3D path: with every launch count set to 0 again, render
     ``intersection(gyroid(0.4, 0.08), sphere(0.85))`` at 1024^3 and
     ``extrude_z(stress_2d(300), -0.4, 0.4)`` at 512^3 through
     ``mpr_tpu_torch.render.render3d``; each frame must launch kernel A
     three times (the three sharing one schedule), C twice, V and D
     once;
  7. hold every recorded launch of A, C, V and D against its plain version
     (all equal, NaNs in the same places),
     each depth image against ``render3d_brute`` (0 pixels differ), and the
     normals against unit length and autograd of the plain interpreter;
  8. time the 3D frame with and without normals, V, D and every launch of
     A and C (C's device time beside its byte bound and share), the device
     time of the frame's prepass (``_shorten_prepass``, the plain PyTorch
     that feeds kernel C), and profile a frame;
  8b. the launch shapes: print the shape ``voxel_launch`` and
     ``deriv_launch`` picked at each 3D cell, then call V and D again on
     the recorded inputs of each 3D cell, A and B on those of each 2D
     cell, A on each of the three launches of each 3D cell, and C on each
     of its launches at all four cells, with forced shapes that reach every
     branch (V, D, B: each home of the register file, K = 1/2/4, P = 1 and
     more, the full tape staged and read from global memory; A: a block a
     tile at 32 to 1024 threads, a thread a tile at 64 to 256 tiles a
     block, the planes staged or not; C: a warp a row at 1 to 32 rows a
     block, a block a row at 128 to 1024 threads), hold each output
     bit for bit against the plain output of phase 3 or 7, and time each
     shape (shapes that do not fit are printed as refused);
  9. kernels B1, C1 and C2 (the earlier public versions of B and C, which
     no render path calls) on the recorded data of the 1024^2 frame: with
     every launch count set to 0, C1 on every ambiguous tile at ``cap =
     Tcap``, ``Tcap/8`` and ``Tcap/16`` (some tapes overflow the last), B1
     on C1's tapes, C2 on the prepass planes in tile order; then each
     against its plain version, C1's lengths and run headers against the
     prepass's and kernel C's, B1's signs against the frame's fill, C2's
     outputs against kernel C's; each timed, B1's and C1's device time
     beside kernel B's and C's (aim: at most ``V1_AIM`` times theirs,
     printed held or missed) and the prepass plus C's; then B1 at the
     forced shapes of ``EDGE_B1`` (each home, K = 1, 2, 4, P = 1, 4, 16
     and 64, no tape staged) and with all ``cap`` clauses staged, at a
     ragged P (the first 1000 pixels of each tile) and
     on the full ``stress_2d(1500)`` tape (longer than it stages: read
     from global memory; and, forced, the whole tape staged), C1 at those of ``EDGE_C1`` (a warp a row, a
     block a row) on the frame and on the gyroid 3D frame's 16^3 stage
     (short planes, a warp a row), each bit for bit against its plain
     version and timed (rows of the ``launch_sweep`` line);
 10. the command line: ``python -m mpr_tpu_torch.cli`` as a subprocess from
     a temporary directory (``render2d stress:600 --size 1024 --check``,
     ``render3d`` of a ``.frep`` scene at 512^3 ``--mode all``, ``render2d
     examples/text_demo.io --check``, ``shorten-stats``), and once in
     process with the launch counts set to 0, where A, C, B, V and D must
     have launched;
 11. the effects (``draw_ssao`` in both modes, ``draw_shaded``) on the
     1024^2 depth and normals, on the card against the same tensors on the
     CPU, and timed;
 13. the unrolled engine (run after phase 11, before the report): the
     kernels ``ops/unrolled_eval.py`` generates for the tapes of the
     ``stress_2d(600)`` 1024^2, gyroid 1024^3 and extruded 512^3 cells
     (float, interval and deriv in the forms the launch picker takes,
     split P = 8 and lanes K = 1, K = 2 for a float tape bound by bytes,
     and the serial form of their first design; the sweep's forced forms,
     ``UNROLLED_SWEEP``; every form of a min/max probe; their nvcc
     processes start with phase 1's, the builds' seconds printed against
     ``UNROLLED_BUILD_S``), each one's nvcc seconds, ptxas registers,
     stack and spills (a spill in any of them fails the run at its end,
     but for the deriv kernel's serial first design, whose spills are
     printed),
     its SASS instructions a lane (``cuobjdump -sass``), its resident
     blocks an SM (the serial form's from its registers) and its peak of
     live values (the serial form's in tape order, the lanes form's
     scheduled, against tape order's, the split form's in its longest
     part and its top) and the split's warps, top, longest warp and
     statements computed twice; the probe's min.NaN / max.NaN and nmin / nmax against
     torch.minimum / maximum on every pair of +-0, +-inf, NaN, subnormal
     and ordinary values; then with the counts set to 0 before each frame
     ``render.unrolled.render2d`` / ``render3d`` on each cell, twice on a
     3D cell (the first frame takes the full ladder, the second the
     renderer's own choice, skip4 at gyroid): a 2D frame must launch the
     interval kernel twice (both split) and the float kernel once, a 3D
     frame the interval kernel three times (twice under skip4; a full
     ladder's first launch split), the float kernel once for each chunk of
     at most 2^26 voxel lanes (lanes form at the extruded cell) and the
     deriv kernel once, and no frame may run a plain evaluator; every
     recorded launch bit for bit against its plain version (all four
     outputs of a deriv launch), at its own form, at the first design's
     and, on a cell's first frame, at the sweep's; the images against ``render*_brute`` and the interpreter
     engine (0 pixels differ; normals within 1e-4), each frame timed on
     the branch it checked and its launches timed by form (events, device
     time, lane-clauses per second beside kernel B's and V's, the
     operations bound and the issue floor: SASS instructions a lane x
     lanes / (132 x 4 x 32 x the card's SM clock)), each cell's device
     time against the first design's in the same run (held or missed:
     within 10%, the deriv kernel at most 0.55x at the extruded cell and
     1.0x at the gyroid) and its recorded first-design time, and, as subprocesses, ``cli
     render2d stress:600 --size 1024 --engine unrolled --check`` and ``cli
     table3d`` on the gyroid model at the table's sizes;
 14. mesh export and fitting (after phase 13): the generated kernels of
     the fits (imm-input interval and float evaluators and both halves of
     K1, the unrolled float evaluator's VJP, for the three cells' tapes)
     build beside phase 1's; ``io.mesh.mesh_tape`` of the gyroid at n=128
     with both methods (the drilled sphere's mt mesh and the sphere's dc
     mesh must be watertight); the five fit steps of
     ``parallel/sharded.py`` (scan, unrolled and culled at 256^2 and
     culled at 1024^2 on ``stress_2d(600)``, dense 3D ``grid=32`` on the
     gyroid, the 3D window fit at 512 on the extruded model, each against
     a render of its tape with seeded perturbed immediates): the first
     step's gradient through the kernels against the same step through
     the plain versions (1e-4 of the largest component), the loss over
     four steps (it must fall), each step timed, the launch counts (K1 or
     K2 must launch, no plain evaluator may run); K1's and K2's launch
     shapes with their ptxas registers (a spill in any K1 or K2 kernel
     fails the run at its end); K1 and K2 on their recorded inputs
     against their plain versions, timed beside their bounds (operations
     counted from the tape's forward walk and its VJP rules,
     ``vjp_plan.vjp_ops``) and K1's and K2's designs' own byte floors
     (what the storage plan writes and reads), K2 also at forced launch
     shapes; the scan fit's K2f launch (one a step: it stores the plan in
     the forward pass) as phase 15 holds and times a launch, storing and
     not, with the step's K2f device time beside the first design's two
     launches; the sharded renders and a sharded step under an NCCL group
     of one, equal to the one-device results; ``cli fit`` (three engines,
     both modes, ``--params-only``) and ``cli mesh`` (both methods) as
     subprocesses, and ``cli render2d --sharded --check`` on both engines;
 15. (run after phase 7) kernel K2f at the dense references: with its
     count set to 0, ``render2d_brute`` of each 2D cell and
     ``render3d_brute`` of each 3D cell (equal to phases 3's and 7's
     images; K2f must launch once a 2D frame, once a slab of rows in 3D);
     on the recorded lanes of the 2D launches and of each 3D cell's middle
     slab, K2f at its picked shape and every shape of ``SCAN_SWEEP`` bit
     for bit against its first design and its plain version, each timed
     (device ms, torch.profiler) beside the first design's and the bound,
     with the walk's file slots against the tape's, the shape and ptxas's
     registers, stack and spills; the report says whether any launch ran
     slower than the first design;
 16. (run after phase 13, so the generated kernels of its cells are built)
     the native tape compiler and the viewer: (a) ``mpr_tpu_torch.native``
     builds with g++ (a failed build fails the run); ``stress_2d(600)``,
     ``stress_2d(1500)``, both 3D cells' trees and every shape of
     ``examples/*.py`` and ``*.io`` compile with ``backend='native'`` and
     ``'python'`` in both schedules to bit-equal tapes (a tree with named
     parameters: the Python tape under ``'auto'``, ``'native'`` refuses
     it), each timed both ways (the mean of 100 compiles after a warm-up,
     as ``cli tape-time``; for the big tapes also ``flatten_tree``, the
     Python half of a native compile) beside the host CPU's model name, and
     phase 2's 1024^2 frame renders from the native tape equal to phase
     2's image; (b) ``viewer.render_scene`` of ``stress_2d(600)`` in 2D at
     1024^2 on the interpreter (A, C and B launched) equal to
     ``pipeline2d.render2d`` flipped; ``examples/gyroid_demo.py`` at 512^2
     in the four 3D modes on both engines (A, C, V and D launched on the
     interpreter, the generated kernels on the unrolled engine), each
     equal to the image composed from the engines' ``render3d`` and the
     effects on the card, the heightmap and normals equal across the
     engines; ``examples/parametric.io`` on the unrolled engine: after its
     first frame three slider moves build and load no generated kernel,
     each equal to a fresh render of ``with_params``; the HTTP loop on
     127.0.0.1 with the render thread on a stream of its own (the page, a
     frame, an engine switch and back: every hand-written and generated
     kernel's wrapper in that thread passes it the thread's stream, and
     torch.profiler's trace puts their kernels on the stream of a marker
     kernel launched there, not on the main thread's (a trace that drops
     a marker's record is taken again, three times in all); then an
     edited script whose unrolled kernels build cold in the thread, its
     ``/frame.png`` equal to ``render_scene``); the frame times (median of
     10 after warm-up, the host's ``compile_tree`` and a 3D frame's
     effects apart) of the 2D frame (on the interpreter also with the
     Python passes) and of the gyroid in every 3D mode, on both engines;
 17. (run after phase 13, so the generated kernels of its cells are built)
     the unrolled 3D ladder's options at both 3D cells, skip4 off: with the
     counts set to 0 before each, the single-phase frame, the two-phase
     frame (``frame3d(two_phase=True)``) and the 2^3 sub-refinement
     (``_render3d_impl(refine2=True)``): each must launch the interval
     kernel three times (the refined frame once more for each chunk of
     2^3 children), the float kernel once for each chunk of each voxel
     stage and the deriv kernel once, and run no plain evaluator; each
     depth equal to the single phase's and ``render3d_brute``'s (0 pixels
     differ) and the normals to the single phase's; the launches of a new
     shape (the children's interval launches, the float launches of both
     phases and of 2^3 voxels) bit for bit against their plain versions;
     the counts (n2, the two phases' na and nb and the cells phase 2
     culled, the ambiguous children m3 against 8 n2); each frame's ms
     (events, median of 10), its generated kernels' and other device
     time and busy share (torch.profiler), and its ms at each
     ``debug_stage`` stop;
 12. print the kernel times of the previous designs of A, B, C, C2, V, D,
     K1, K2 and the generated float and interval kernels (recorded,
     labelled as such; not measured here), the unrolled sweep and the
     comparison with the first design (measured in phase 13), the card
     line, one
     JSON line of phase 16's compile and frame times, one
     JSON ``kernels`` line (the eight TPU kernels' rows, then the three
     generated kernels' and K1, K2 and K2f, marked ``port_kernel``), and
     last ``{"ok": true, "device": {...}}``.

Exits non-zero when no CUDA device is present and when run outside the
repository (it needs the ``mpr_tpu_torch`` package beside it).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM float32 outside the tensor cores, one operation a lane a clock:
# 132 SMs x 128 lanes x 1.98 GHz.  The data sheet's 67 TFLOP/s counts a
# fused multiply-add as two; the kernels build with --fmad=false and the
# bound counts single IEEE operations, so an FMA is never issued.
PEAK_F32_PER_S = 33.5e12
KERNEL_ROWS = (
    # wrapper (its plain version is <wrapper>_plain), its module under
    # mpr_tpu_torch.ops, source, the TPU kernel it replaces
    ("interval_shorten", "kernels",
     "mpr_tpu_torch/ops/csrc/interval_shorten.cu",
     "mpr_tpu/ops/kernels.py:511"),
    ("compact_bitshift_batched", "kernels",
     "mpr_tpu_torch/ops/csrc/compact.cu", "mpr_tpu/ops/kernels.py:1206"),
    ("pixel_eval_runs", "kernels", "mpr_tpu_torch/ops/csrc/pixel_eval.cu",
     "mpr_tpu/ops/kernels.py:988"),
    ("voxel_eval_3d", "kernels3d", "mpr_tpu_torch/ops/csrc/voxel_eval.cu",
     "mpr_tpu/ops/kernels3d.py:186"),
    ("deriv_eval_3d", "kernels3d", "mpr_tpu_torch/ops/csrc/deriv_eval.cu",
     "mpr_tpu/ops/kernels3d.py:456"),
    ("pixel_eval", "kernels", "mpr_tpu_torch/ops/csrc/pixel_eval_v1.cu",
     "mpr_tpu/ops/kernels.py:661"),
    ("compact_runs", "kernels", "mpr_tpu_torch/ops/csrc/compact_runs.cu",
     "mpr_tpu/ops/kernels.py:832"),
    ("compact_bitshift", "kernels",
     "mpr_tpu_torch/ops/csrc/compact_order.cu",
     "mpr_tpu/ops/kernels.py:1260"),
)
# no render path calls these three: the kernel phase drives them
KERNELS_V1 = ("pixel_eval", "compact_runs", "compact_bitshift")
# The port's own kernels of the unrolled engine (phase 13): generated per
# tape by mpr_tpu_torch/ops/unrolled_eval.py, one kind a semantics; the
# wrapper in that module, and the JAX package's evaluator it stands for
# (XLA code there, no pallas_call).
UNROLLED_ROWS = (
    ("unrolled_interval", "unrolled_eval",
     "mpr_tpu/ops/unrolled_eval.py:411 (build_interval; XLA, no TPU "
     "kernel)"),
    ("unrolled_float", "unrolled_eval",
     "mpr_tpu/ops/unrolled_eval.py:397 (build_float; XLA, no TPU kernel), "
     "mpr_tpu/render/brute.py:88"),
    ("unrolled_deriv", "unrolled_eval",
     "mpr_tpu/ops/unrolled_eval.py:421 (build_deriv; XLA, no TPU kernel)"),
)
UNROLLED_SOURCE = ("mpr_tpu_torch/ops/unrolled_eval.py (generated per "
                   "tape) + mpr_tpu_torch/ops/csrc/unrolled.cuh")
# launches of each evaluator a 2D frame of the unrolled engine must make
# (a 3D frame's follow from its branch and counts, run_unrolled)
UNROLLED_2D = {"unrolled_interval": 2, "unrolled_float": 1,
               "unrolled_deriv": 0}
# Float operations of a generated statement, for the bound: one per IEEE
# arithmetic operation or math-library call, the Cephes forms counted out;
# none for compares, selects, min/max, loads and stores.
GEN_CALL_OPS = {"sqrtf": 1, "sinf": 1, "cosf": 1, "expf": 1, "logf": 1,
                "asinf": 1, "acosf": 1, "atanf": 1, "c_asin": 14,
                "c_acos": 15, "c_atan": 15, "floorf": 1, "ceilf": 1}
# limits of the card-against-CPU comparison of the effects (the card-only
# tests use the same): share of pixels further apart than 1e-5, and the
# largest difference
EFFECT_SHARE = 0.01
EFFECT_FAR = 0.05
KERNELS_2D = ("interval_shorten", "compact_bitshift_batched",
              "pixel_eval_runs")
# launches a 3D frame with normals must make
LAUNCHES_3D = {"interval_shorten": 3, "compact_bitshift_batched": 2,
               "voxel_eval_3d": 1, "deriv_eval_3d": 1}
CASES = ((600, 1024), (1500, 2048))   # (stress_2d blobs, image size)
# (name, tree from the shape library, gui3d_view(yaw, pitch, perspective),
# size)
CASES_3D = (
    ("gyroid_sphere", lambda S: S.intersection(S.gyroid(0.4, 0.08),
                                               S.sphere(0.85)),
     (0.5, -0.9, 0.3), 1024),
    ("extruded_stress", lambda S: S.extrude_z(S.stress_2d(300), -0.4, 0.4),
     (0.7, -1.0, 0.3), 512),
)
# Float operations per clause, by opcode, for the bound: one per IEEE
# arithmetic operation or math-library call of the clause's formula (the
# Cephes forms counted out), none for compares, selects and copies.
FLOAT_OPS = {2: 1, 3: 1, 4: 1, 5: 1, 6: 1, 7: 14, 8: 15, 9: 15, 10: 1,
             11: 1, 12: 1, 13: 1, 14: 1, 15: 1, 16: 1, 17: 1, 18: 1, 19: 1,
             20: 1, 21: 1, 22: 1, 23: 1, 24: 1, 25: 1, 26: 1, 27: 0, 28: 0,
             29: 0, 30: 4, 31: 2}
INTERVAL_OPS = {2: 2, 3: 2, 4: 2, 5: 0, 6: 0, 7: 28, 8: 30, 9: 30, 10: 2,
                11: 2, 12: 2, 13: 2, 14: 2, 15: 2, 16: 4, 17: 2, 18: 2,
                19: 2, 20: 2, 21: 2, 22: 2, 23: 2, 24: 2, 25: 2, 26: 4,
                27: 0, 28: 0, 29: 0, 30: 8, 31: 4}
# The same count for a dual-number clause (value and three derivatives),
# from the formulas of clause.cuh's deriv_op: e.g. mul is one product for
# the value and two products and a sum for each derivative.
DERIV_OPS = {2: 5, 3: 6, 4: 4, 5: 5, 6: 6, 7: 21, 8: 22, 9: 21, 10: 5,
             11: 4, 12: 5, 13: 1, 14: 4, 15: 4, 16: 10, 17: 1, 18: 1, 19: 1,
             20: 1, 21: 1, 22: 4, 23: 4, 24: 5, 25: 6, 26: 11, 27: 1, 28: 0,
             29: 0, 30: 17, 31: 9}
# per voxel or pixel: three index-to-coordinate conversions and the mat4
COORD_OPS = 42
# Kernel times of the designs before the redesigns (V and D before their
# register-file redesign, at the two 3D cells; A before the level walk and
# B before the register file of regfile.cuh, at the 1024^2 cell; C before
# its warp-a-row and block-a-row redesign, device time summed over a
# frame's launches at each cell; C2 the same, events at the 1024^2 cell;
# K1 and K2 at the fits of phase 14):
# recorded by this script on NVIDIA H100 80GB HBM3, 700.00 W, and printed
# on a line of their own as recorded values, apart from this run's
# measurements.
PREVIOUS_DESIGN_MS = {"voxel_eval_3d": {"gyroid_sphere": 15.221,
                                        "extruded_stress": 8.575},
                      "deriv_eval_3d": {"gyroid_sphere": 0.250,
                                        "extruded_stress": 8.057},
                      "interval_shorten": {"stress_2d(600) 1024^2": 1.9068},
                      "pixel_eval_runs": {"stress_2d(600) 1024^2": 1.0148},
                      "compact_bitshift_batched": {
                          "stress_2d(600) 1024^2": 0.0078,
                          "stress_2d(1500) 2048^2": 0.0790,
                          "gyroid_sphere": 0.2902,
                          "extruded_stress": 0.3162},
                      "compact_bitshift": {"stress_2d(600) 1024^2": 0.0438},
                      # B1 and C1 before their redesign (a block a tile and
                      # a thread a pixel on a 256-slot local array; a block
                      # a row and a thread a code word), device time in
                      # phase 9 of the run before it
                      "pixel_eval": {"stress_2d(600) 1024^2": 1.2391},
                      "compact_runs": {"stress_2d(600) 1024^2": 0.0109},
                      # K1 and K2 before their redesign (the clause values
                      # all stored, adjoints handed over in a zero-filled
                      # plane; K2's file in local memory, a lane a thread),
                      # device time of a call at each fit of phase 14
                      "unrolled_float_vjp": {"culled 1024^2": 96.825,
                                             "3d window 512": 75.961,
                                             "unrolled 256^2": 6.700,
                                             "3d grid=32": 0.0121},
                      "scan_adjoint": {"scan 256^2": 29.977},
                      # the generated float and interval kernels' first
                      # design (tape order, a thread a lane), device
                      # time of a frame's launches at each cell of phase 13
                      "unrolled_float": {
                          "stress_2d(600)": 0.2768, "gyroid_sphere": 3.0215,
                          "gyroid_sphere steady": 3.3506,
                          "extruded_stress": 4.8284,
                          "extruded_stress steady": 4.8284},
                      "unrolled_interval": {
                          "stress_2d(600)": 0.2751, "gyroid_sphere": 0.0749,
                          "gyroid_sphere steady": 0.0034,
                          "extruded_stress": 1.6119,
                          "extruded_stress steady": 1.6119},
                      # the deriv kernel's (the same serial form), the
                      # normals' one launch a 3D frame
                      "unrolled_deriv": {
                          "gyroid_sphere": 0.0111,
                          "gyroid_sphere steady": 0.0111,
                          "extruded_stress": 0.3651,
                          "extruded_stress steady": 0.3651}}
# Phase 13's sweep of forced forms of the generated kernels (ops/launch.py
# UnrolledLaunch), by cell: each recorded launch of the cell's first frame
# also runs at these, held bit for bit against its plain version and timed
# (the serial form of the first design runs at every frame).  The form the
# picker takes at a launch needs no entry.
UNROLLED_SWEEP = {
    "stress_2d(600)": {"interval": (("split", 4), ("split", 32))},
    "gyroid_sphere": {"float": (("lanes", 1), ("lanes", 4)),
                      "deriv": (("lanes", 1), ("split", 4), ("split", 8),
                                ("split", 32))},
    "extruded_stress": {"float": (("lanes", 2), ("lanes", 4), ("split", 32)),
                        "interval": (("lanes", 2), ("split", 4),
                                     ("split", 32)),
                        "deriv": (("lanes", 2), ("split", 4), ("split", 8),
                                  ("split", 32))}}
# Phase 13's aims of a kernel's device time against its first design's in
# the same run (printed as held or missed): by kernel and cell, else 1.1
FIRST_DESIGN_AIM = {"unrolled_deriv": {"extruded_stress": 0.55,
                                       "gyroid_sphere": 1.0}}
# seconds phase 13's builds should take at most (their nvcc processes run
# beside phase 1's and 14's): printed as held or missed
UNROLLED_BUILD_S = 120.0
# Kernel A's dependency bound: each level costs a shared-memory round trip
# (about 30 cycles) and a barrier (about 20 cycles), at 1.98 GHz, twice (the
# forward and the backward pass).  An estimate from the card's published
# latencies, not a measurement.
LEVEL_STEP_NS = 25.0


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, reps, warmup=2):
    """Median device time of ``fn()`` in ms, CUDA events around each run."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def plain_ms(fn):
    """Time of a plain version: one run, and the median of three when a run
    takes under two seconds."""
    first = cuda_ms(fn, 1, 0)
    return first if first > 2000.0 else cuda_ms(fn, 3, 0)


def profile_frames(fn, n=5):
    """Device time by kernel name over ``n`` frames (torch.profiler's CUDA
    activity): returns (host ms per frame, [(name, device ms per frame)],
    device busy share of the window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    busy = sum(by_name.values())
    rows = sorted(((k, v / n / 1e3) for k, v in by_name.items()),
                  key=lambda kv: -kv[1])
    return wall_us / n / 1e3, rows, busy / wall_us


def device_ms(fn, n=10, name=None, tries=1):
    """Device time of the one kernel ``fn()`` launches, in ms: the mean
    duration of the kernels torch.profiler traces over ``n`` calls (the
    mean of those traced, which holds where the trace drops a record), or
    of those whose name holds ``name`` where ``fn`` launches others too.
    The events of :func:`cuda_ms` also time the host's work around a
    short kernel's launch; this does not.  A trace with no such record is
    taken again, ``tries`` times in all; then None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and (name is None or name in e.name)]
        if us:
            return round(sum(us) / len(us) / 1e3, 6)
    return None


def print_profile(label, fn, card, n):
    wall, rows, busy = profile_frames(fn, n)
    if not rows:
        print(f"profile {label}: no device time in the trace (not measured)")
        return
    print(f"profile {label}: {wall:.3f} ms per frame (host clock under the "
          f"profiler), device busy {100 * busy:.1f}%, "
          f"{sum(v for _, v in rows):.3f} ms of kernels over {len(rows)} "
          f"kernel names  [{card}]")
    for name, ms in rows[:12]:
        print(f"    {ms:9.4f} ms  {name[:100]}")


class Recorder:
    """Routes each kernel wrapper through a function that keeps the inputs
    and outputs of every launch in ``log``; the original wrappers still
    count their launches."""

    def __init__(self, mods, rows=KERNEL_ROWS):
        self.mods = mods
        self.rows = rows
        self.originals = {name: getattr(mods[mod], name)
                          for name, mod, *_ in rows}

    def reset_counts(self):
        for fn in self.originals.values():
            fn.launches = 0

    def counts(self):
        return {name: fn.launches for name, fn in self.originals.items()}

    def install(self, log):
        for name, mod, *_ in self.rows:
            def rec(*a, _fn=self.originals[name], _name=name, **k):
                out = _fn(*a, **k)
                log.setdefault(_name, []).append((a, k, out))
                return out
            setattr(self.mods[mod], name, rec)

    def remove(self):
        for name, mod, *_ in self.rows:
            setattr(self.mods[mod], name, self.originals[name])


def interval_ops(tape):
    return sum(INTERVAL_OPS.get(int(o), 0) for o in tape.ops)


def row_ops(gmeta, runs_h, table, full_ops, per_op):
    """Operations per pixel or voxel summed over the rows of ``gmeta``, from
    the tapes kernel C produced: ``per_op`` counts one opcode, a row that
    overflowed runs the full tape (``full_ops``)."""
    import numpy as np
    lut = np.zeros(256, np.int64)
    for o, n in per_op.items():
        lut[o] = n
    total = 0
    for g in range(gmeta.shape[0]):
        if gmeta[g, 2]:
            total += full_ops
            continue
        hdr = runs_h[g, :gmeta[g, 1]]
        total += int((lut[table[hdr & 0xFF]] * (hdr >> 8)).sum())
    return total


def same(a, b):
    """Mismatch count and max |a - b| with NaNs in the same places equal."""
    import torch
    if a.is_floating_point():
        bad = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
        d = torch.nan_to_num((a - b).abs(), nan=0.0, posinf=0.0)
        err = float(torch.where(bad, d, torch.zeros_like(d)).max()) \
            if a.numel() else 0.0
    else:
        bad = a != b
        err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return int(bad.sum()), err


def levels_of(kwargs):
    """The dependency schedule a recorded launch of kernel A was given (the
    tape's ``TapeData.levels``, built at the frame's first launch)."""
    lv = kwargs["levels"]
    return lv() if callable(lv) else lv


def print_levels(label, lv):
    print(f"schedule {label}: {lv.length} clauses on {lv.n_levels} "
          f"dependency levels, widest {lv.widest}; built on the host in "
          f"{1e3 * lv.seconds:.2f} ms (once a tape)")


def a_mismatches(tk, out, plain):
    """Status mismatches, and code word mismatches on the lanes the plain
    version finds ambiguous (the others' codes are never read)."""
    (st, codes), (pst, pcodes) = out, plain
    amb = pst == tk.ST_AMBIG
    n_st, e_st = same(st, pst)
    n_codes, e_codes = same(codes[amb], pcodes[amb])
    return n_st, n_codes, max(e_st, e_codes)


def compare_a(tk, entry, tape, label, keep=None):
    """One recorded launch of kernel A against its plain version (whose
    outputs go to the list ``keep`` for the launch-shape phase)."""
    a, k, out = entry
    plain = tk.interval_shorten_plain(*a, **k)
    if keep is not None:
        keep.append(plain)
    n_st, n_codes, err = a_mismatches(tk, out, plain)
    lanes, tcap = out[1].shape[0], a[1].shape[0]
    lv = levels_of(k)
    print(f"  A interval_shorten {label}: {lanes} lanes, "
          f"{int((plain[0] == tk.ST_AMBIG).sum())} ambiguous, "
          f"{lv.n_levels} levels; status mismatches {n_st}, code word "
          f"mismatches on ambiguous lanes {n_codes}")
    return dict(mismatches=n_st + n_codes, max_abs_err=err,
                bytes=32 + 8 * tape.length + 24 * lanes + 4 * lanes
                + lanes * tcap // 2,
                ops=lanes * interval_ops(tape), levels=lv.n_levels,
                dep_bound_ms=2 * lv.n_levels * LEVEL_STEP_NS * 1e-6)


def c_mismatches(out, pout, n_rows):
    """Kernel C's mismatches against the plain output on the rows below
    cmeta[0]: tw, ti and the run headers over the full cap (the zeros past
    the tape included), and gmeta's [len, n_runs, overflow]."""
    mism, err = {}, 0.0
    for n, o, p in zip(("tw", "ti", "runs"), out[:3], pout[:3]):
        mism[n], e = same(o[:n_rows], p[:n_rows])
        err = max(err, e)
    mism["gmeta"], e = same(out[3][:n_rows, :3], pout[3][:n_rows, :3])
    return mism, max(err, e)


def compare_c(tk, entry, tape, label, keep=None):
    """One recorded launch of kernel C against its plain version (whose
    outputs go to the list ``keep`` for the launch-shape phase); also
    returns the rows' gmeta and run headers (host) for the bounds."""
    a, k, out = entry
    n_rows = int(a[0][0])
    tcap = a[2].shape[1] * a[2].shape[2]
    pout = tk.compact_bitshift_batched_plain(*a, **k)
    if keep is not None:
        keep.append(pout)
    mism, err = c_mismatches(out, pout, n_rows)
    gmeta = out[3][:n_rows].cpu().numpy()
    cap = out[0].shape[1]
    kept = int(gmeta[:, 0].sum())
    print(f"  C compact {label}: {n_rows} rows, mean kept "
          f"{kept / max(n_rows, 1):.1f} clauses of {tape.length}, "
          f"{int(gmeta[:, 2].sum())} over cap {cap}; mismatches {mism}")
    res = dict(mismatches=sum(mism.values()), max_abs_err=err,
               bytes=4 * n_rows * tcap + 8 * kept + 4 * n_rows
               + n_rows * (12 * cap + 32), ops=0, rows=n_rows, tcap=tcap,
               cap=cap)
    return res, gmeta, out[2][:n_rows].cpu().numpy(), kept


def print_c_share(label, r, card):
    """Kernel C's device time at one launch beside its byte bound, and the
    share of the bound it reaches (kept in ``r``)."""
    b_ms, _ = bound(r)
    dev = r.get("device_ms")
    r["share_of_bound"] = b_ms / dev if dev else None
    print(f"  C compact {label}: {r['rows']} rows of {r['tcap']} clauses, "
          f"cap {r['cap']}: device {dev} ms, byte bound {b_ms:.5f} ms, "
          + (f"{100 * b_ms / dev:.1f}% of the bound" if dev
             else "share not measured") + f"  [{card}]")


def time_prepass(fn_frame, card, label, module=None):
    """Device time of the prepass (``_shorten_prepass``, the plain PyTorch
    that feeds kernel C) over one frame of ``module`` (``pipeline3d``; or
    ``pipeline2d`` for a 2D frame): its calls are recorded in a frame,
    then replayed and profiled (the sum of its kernels' device time) and
    timed with events."""
    import torch
    if module is None:
        from mpr_tpu_torch.render import pipeline3d as module
    calls = []
    orig = module._shorten_prepass

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)
    module._shorten_prepass = rec
    try:
        fn_frame()
    finally:
        module._shorten_prepass = orig
    torch.cuda.synchronize()

    def replay():
        for a, k in calls:
            orig(*a, **k)
    ev = cuda_ms(replay, 5, 1)
    _, rows, _ = profile_frames(replay, 3)
    dev = sum(ms for _, ms in rows) if rows else None
    print(f"  prepass {label}: {len(calls)} calls a frame, device "
          + (f"{dev:.4f} ms" if dev is not None else "not measured")
          + f" over {len(rows)} kernel names, {ev:.4f} ms (events)  [{card}]")
    return {"calls": len(calls), "device_ms": dev, "ms": ev}


def compare_kernels(tk, rec, tape, size):
    """Hold each 2D kernel's outputs (recorded on the main path) against its
    plain version on the same CUDA inputs.  Returns per-kernel dicts with
    mismatch counts, max |err| and the data the bounds need."""
    import torch
    res = {"plain": {"interval_shorten": []}}
    res["interval_shorten"] = compare_a(tk, rec["interval_shorten"][0], tape,
                                        f"@{size}^2",
                                        res["plain"]["interval_shorten"])
    res["plain"]["compact_bitshift_batched"] = []
    res["compact_bitshift_batched"], gmeta, runs_h, kept = compare_c(
        tk, rec["compact_bitshift_batched"][0], tape, f"@{size}^2",
        res["plain"]["compact_bitshift_batched"])
    n_amb = gmeta.shape[0]

    (a, k, fill) = rec["pixel_eval_runs"][0]
    pfill = res["plain"]["pixel_eval_runs"] = tk.pixel_eval_runs_plain(*a,
                                                                       **k)
    diff = fill != pfill
    n_fill = int(diff.sum())
    if n_fill:
        idx = torch.nonzero(diff)[:10].tolist()
        print(f"  B differing (tile, pixel): {idx}")
    table = tk.bid_table(a[6])
    full_ops = sum(FLOAT_OPS.get(int(o), 0) for o in tape.ops)
    P = fill.shape[1]
    flops = P * row_ops(gmeta, runs_h, table, full_ops, FLOAT_OPS)
    fits = gmeta[:, 2] == 0
    res["pixel_eval_runs"] = dict(
        mismatches=n_fill, max_abs_err=float((fill - pfill).abs().max()),
        bytes=n_amb * 3 * P * 4 + fill.numel() * 4 + 12 * kept,
        ops=flops, clauses=P * (int(gmeta[fits, 0].sum())
                                + int((~fits).sum()) * tape.length))
    print(f"  B pixel_eval_runs @{size}^2: fill mismatches {n_fill}; "
          f"{int(fits.sum())} tiles on their own tapes, mean "
          f"{gmeta[fits, 0].mean() if fits.any() else 0:.1f} clauses in "
          f"{gmeta[fits, 1].mean() if fits.any() else 0:.1f} opcode runs")
    return res


def compare_kernels_3d(tk, tk3, rec, tape, name, keep):
    """Hold every launch of A, C, V and D that one 3D frame recorded against
    the plain versions on the same CUDA inputs.  Returns per-kernel dicts
    (for A and C a list, one per launch); the plain outputs of V and D go
    to ``keep`` for the launch-shape phase."""
    res = {"interval_shorten": [], "compact_bitshift_batched": []}
    stages = ("64^3 tiles", "16^3 cells", "z columns")
    keep["interval_shorten"] = []
    for entry, stage in zip(rec["interval_shorten"], stages):
        res["interval_shorten"].append(
            compare_a(tk, entry, tape, f"{name} {stage}",
                      keep["interval_shorten"]))
    c_rows = []
    keep["compact_bitshift_batched"] = []
    for entry, stage in zip(rec["compact_bitshift_batched"],
                            ("cells", "columns")):
        r, gmeta, runs_h, kept = compare_c(tk, entry, tape, f"{name} {stage}",
                                           keep["compact_bitshift_batched"])
        res["compact_bitshift_batched"].append(r)
        c_rows.append((gmeta, runs_h, kept))

    # ---- V: every ambiguous cell --------------------------------------------
    a, k, vals = rec["voxel_eval_3d"][0]
    n_amb1 = int(a[0][0])
    gmeta, runs_h, kept = c_rows[0]
    pvals = tk3.voxel_eval_3d_plain(*a, **k)
    n_v, e_v = same(vals[:n_amb1], pvals[:n_amb1])
    n_sign = int(((vals[:n_amb1] < 0) != (pvals[:n_amb1] < 0)).sum())
    keep["voxel_eval_3d"] = pvals
    table = tk.bid_table(a[7])
    full_f = sum(FLOAT_OPS.get(int(o), 0) for o in tape.ops)
    flops = 4096 * (row_ops(gmeta, runs_h, table, full_f, FLOAT_OPS)
                    + n_amb1 * COORD_OPS)
    fits = gmeta[:, 2] == 0
    res["voxel_eval_3d"] = dict(
        mismatches=n_v + n_sign, max_abs_err=e_v, rows=n_amb1,
        bytes=12 * kept + 4 * int(gmeta[:, 1].sum()) + 36 * n_amb1
        + 4 * a[2].numel() + 64 + n_amb1 * 4096 * 4,
        ops=flops, clauses=4096 * (int(gmeta[fits, 0].sum())
                                   + int((~fits).sum()) * tape.length))
    print(f"  V voxel_eval_3d {name}: {n_amb1} cells, "
          f"{int(gmeta[:, 2].sum())} overflowed: value mismatches {n_v}, "
          f"sign mismatches {n_sign}, max |err| {e_v:.3g}")

    # ---- D: every tile with content ----------------------------------------
    a, k, out = rec["deriv_eval_3d"][0]
    n_act = int(a[0][0])
    gmeta, runs_h, kept = c_rows[1]
    pout = tk3.deriv_eval_3d_plain(*a, **k)
    n_d, e_d = same(out[:n_act], pout[:n_act])
    keep["deriv_eval_3d"] = pout
    full_d = sum(DERIV_OPS.get(int(o), 0) for o in tape.ops)
    flops = 4096 * (row_ops(gmeta, runs_h, table, full_d, DERIV_OPS)
                    + n_act * COORD_OPS)
    res["deriv_eval_3d"] = dict(
        mismatches=n_d, max_abs_err=e_d, rows=n_act,
        bytes=12 * kept + 4 * int(gmeta[:, 1].sum()) + 36 * n_act + 64
        + n_act * 4096 * 4 + n_act * 4 * 4096 * 4,
        ops=flops)
    print(f"  D deriv_eval_3d {name}: {n_act} tiles of {a[11].shape[0]}, "
          f"{int(gmeta[:, 2].sum())} overflowed: mismatches {n_d}, max "
          f"|err| {e_d:.3g}")
    return res


def check_normals(eval_scan, camera, td, mat_t, depth, normals, size, seed):
    """Unit length where there is depth, zero elsewhere, and on 256 seeded
    pixels the direction autograd gives for the plain interpreter at the
    same sample point (one voxel in front of the surface)."""
    import numpy as np
    import torch
    m = depth > 0
    ln = np.linalg.norm(normals[m], axis=-1)
    check(normals.shape == (size, size, 3) and normals.dtype == np.float32,
          "normals have the wrong shape or type")
    check(np.isfinite(normals).all(), "normals not finite")
    check(np.allclose(ln, 1.0, atol=1e-3), "normals not of unit length")
    check(not normals[~m].any(), "normals outside the surface not zero")
    ys, xs = np.nonzero(m)
    sel = np.random.default_rng(seed).choice(len(ys), 256, replace=False)
    ys, xs = ys[sel], xs[sel]
    zi = np.minimum(depth[ys, xs], size - 1)
    w = [torch.as_tensor(((v + 0.5) / size * 2.0 - 1.0).astype(np.float32),
                         device=mat_t.device) for v in (xs, ys, zi)]
    p = torch.stack(camera.transform3(mat_t, *w)).requires_grad_(True)
    eval_scan.eval_f_plain(td, p[0], p[1], p[2]).sum().backward()
    g = p.grad.cpu().numpy().T
    g = g / np.linalg.norm(g, axis=1, keepdims=True)
    err = float(np.abs(g - normals[ys, xs]).max())
    check(err <= 1e-3, f"normals differ from autograd by {err}")
    return float(np.abs(ln - 1.0).max()), err


def run_2d(ctx, results, launches):
    """Phases 2 to 5: the 2D path."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d, render2d, render2d_brute
    from mpr_tpu_torch.utils.trace import COUNTS
    tk, dev, card, recorder = ctx["tk"], ctx["dev"], ctx["card"], ctx["rec"]

    tapes = {}
    for n_blobs, size in CASES:
        t0 = time.perf_counter()
        tapes[size] = mpr_tpu_torch.compile_tree(shapes.stress_2d(n_blobs))
        t = tapes[size]
        print(f"stress_2d({n_blobs}): {t.length} clauses, {t.num_slots} "
              f"slots, bucket {TapeData.from_tape(t, device='cpu').capacity}"
              f", compiled in {time.perf_counter() - t0:.2f} s")
    recs = {size: {} for _, size in CASES}
    images = {}
    builds = COUNTS['builds.schedule']
    recorder.reset_counts()
    try:
        for _, size in CASES:
            recorder.install(recs[size])
            t0 = time.perf_counter()
            images[size] = render2d(tapes[size], size=size)
            torch.cuda.synchronize()
            print(f"render2d @{size}^2: {time.perf_counter() - t0:.3f} s "
                  "(first frame, host clock)")
    finally:
        recorder.remove()
    counts = recorder.counts()
    launches["2d"] = counts
    print(f"2D path launches over {len(CASES)} frames: {counts}")
    for name in KERNELS_2D:
        check(counts[name] >= len(CASES), f"kernel {name} launched "
              f"{counts[name]} times on the 2D path")
    # each render2d call makes the tape's TapeData, whose schedule its one
    # launch of kernel A builds
    check(COUNTS['builds.schedule'] - builds == len(CASES),
          f"{COUNTS['builds.schedule'] - builds} schedules built over "
          f"{len(CASES)} 2D frames")
    for n_blobs, size in CASES:
        print_levels(f"stress_2d({n_blobs})",
                     levels_of(recs[size]["interval_shorten"][0][1]))

    # ---- kernels vs plain, images vs the dense reference --------------------
    for _, size in CASES:
        img = images[size]
        status = recs[size]["interval_shorten"][0][2][0]
        n_amb = int((status == tk.ST_AMBIG).sum())
        print(f"image @{size}^2: filled fraction {img.mean():.6f}, "
              f"{n_amb} of {status.numel()} tiles ambiguous")
        res = compare_kernels(tk, recs[size], tapes[size], size)
        results[size] = res
        for name in KERNELS_2D:
            r = res[name]
            check(r["mismatches"] == 0, f"{name} disagrees with its plain "
                  f"version at {size}^2 ({r['mismatches']} mismatches)")
        want = render2d_brute(tapes[size], size=size)
        ctx.setdefault("brute2d", {})[size] = want
        bad = img != want
        print(f"  image vs render2d_brute @{size}^2: {int(bad.sum())} pixels "
              "differ")
        check(img.shape == (size, size) and img.dtype == np.bool_,
              "image has the wrong shape or type")
        check(not bad.any(), f"image differs from the dense evaluation at "
              f"{size}^2")
        check(0.0 < img.mean() < 1.0, "image is all empty or all filled")
    torch.cuda.synchronize()

    # ---- an edited tape renders with no new build ----------------------------
    edited = mpr_tpu_torch.compile_tree(shapes.union(
        shapes.circle(0.5), shapes.rectangle(-0.9, -0.2, 0.3, 0.8)))
    img = render2d(edited, size=1024)
    check(np.array_equal(img, render2d_brute(edited, size=1024)),
          "edited tape renders wrong")
    check((COUNTS['builds.load'], COUNTS['builds.compile'])
          == ctx["builds"], "the edited tape caused a new build")
    print(f"edited tape ({edited.length} clauses, another op set): exact, "
          f"libraries loaded still {COUNTS['builds.load']}")

    # ---- timing ----------------------------------------------------------------
    for _, size in CASES:
        rec = recs[size]
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        pipeline2d.render_tile_block(td, eye, z, size)
        builds = COUNTS['builds.schedule']
        frame_ms = cuda_ms(
            lambda: pipeline2d.render_tile_block(td, eye, z, size), 20, 3)
        check(COUNTS['builds.schedule'] == builds, "a 2D frame after the "
              "first on one tape built a schedule")
        t0 = time.perf_counter()
        for _ in range(10):
            pipeline2d.render_tile_block(td, eye, z, size)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 100
        line = [f"frame @{size}^2: {frame_ms:.3f} ms (events), "
                f"{wall_ms:.3f} ms (host clock, mean of 10)"]
        for name in KERNELS_2D:
            a, k, _ = rec[name][0]
            fn = getattr(tk, name)
            ms = cuda_ms(lambda: fn(*a, **k), 30, 3)
            r = results[size][name]
            r["ms"] = ms
            r["device_ms"] = device_ms(lambda: fn(*a, **k))
            if size == CASES[0][1]:
                plain = getattr(tk, name + "_plain")
                r["plain_ms"] = cuda_ms(lambda: plain(*a, **k), 3, 1)
            line.append(f"{name} {ms:.4f} ms (device {r['device_ms']})")
        print("; ".join(line) + f"  [{card}]")
        print_c_share(f"@{size}^2", results[size]["compact_bitshift_batched"],
                      card)

    # ---- where a frame's device time goes -----------------------------------
    for _, size in CASES:
        td = TapeData.from_tape(tapes[size], device=dev)
        eye = torch.eye(3, device=dev)
        z = torch.tensor(0.0, device=dev)
        print_profile(
            f"@{size}^2",
            lambda: pipeline2d.render_tile_block(td, eye, z, size), card, 5)
    size = CASES[0][1]
    ctx["recs2d"] = recs
    ctx["frame2d"] = dict(rec=recs[size], tape=tapes[size], size=size,
                          image=images[size])
    ctx["images2d"] = images


def run_stale_imms(ctx):
    """Phase 5b: kernel A under a schedule built before the tape's
    immediates changed, on the 1024^2 cell's tape and tiles."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d
    tk, dev, card = ctx["tk"], ctx["dev"], ctx["card"]
    n_blobs, size = CASES[0]
    td = TapeData.from_tape(mpr_tpu_torch.compile_tree(
        shapes.stress_2d(n_blobs)), device=dev)
    old = td.levels()                   # built with the tape's own imms
    imms = td.imms.clone()
    noise = np.random.default_rng(56).normal(0.0, 0.05, td.length)
    imms[:td.length] += torch.from_numpy(noise.astype(np.float32)).to(dev)
    boxes = pipeline2d._tile_boxes_2d(size // 64, torch.eye(3, device=dev),
                                      torch.tensor(0.0, device=dev))
    meta, lanes = td.meta(), boxes.shape[1]
    s_cap = max(8, -(-td.num_slots // 8) * 8)
    plain = tk.interval_shorten_plain(meta, td.packed, imms, boxes,
                                      s_cap=s_cap)
    before = tk.interval_shorten_plain(meta, td.packed, td.imms, boxes,
                                       s_cap=s_cap)
    n_old, c_old, _ = a_mismatches(tk, before, plain)
    check(n_old + c_old > 0, "the changed immediates change no status or "
          "code: the phase cannot tell old from new")
    for kw in (None, dict(threads=1024), dict(threads=256, stage=True)):
        launch = None if kw is None else ln.interval_launch(old.widths,
                                                            lanes, **kw)
        out = tk.interval_shorten(meta, td.packed, imms, boxes, s_cap=s_cap,
                                  levels=old, launch=launch)
        torch.cuda.synchronize()
        n_st, n_codes, _ = a_mismatches(tk, out, plain)
        label = "picked" if kw is None else a_label(launch)
        print(f"  A under an old schedule, new imms @{size}^2 [{label}]: "
              f"status mismatches {n_st}, code word mismatches {n_codes} "
              f"(the old imms' plain output differs in {n_old} statuses, "
              f"{c_old} code words)  [{card}]")
        check(n_st + n_codes == 0, "kernel A follows the schedule's "
              f"immediates, not the call's ({label})")


def run_3d(ctx, results, launches):
    """Phases 6 to 8: the 3D path."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import (camera, pipeline3d, render3d,
                                      render3d_brute)
    from mpr_tpu_torch.utils.trace import COUNTS
    tk, tk3, dev, card, recorder = (ctx["tk"], ctx["tk3"], ctx["dev"],
                                    ctx["card"], ctx["rec"])

    tapes, mats = {}, {}
    for name, make, view, size in CASES_3D:
        t0 = time.perf_counter()
        tapes[name] = t = mpr_tpu_torch.compile_tree(make(shapes))
        mats[name] = camera.gui3d_view(*view)
        print(f"{name}: {t.length} clauses, {t.num_slots} slots, bucket "
              f"{TapeData.from_tape(t, device='cpu').capacity}, compiled in "
              f"{time.perf_counter() - t0:.2f} s")

    # ---- the main path: render3d, every launch recorded ----------------------
    recs = {name: {} for name, *_ in CASES_3D}
    frames = {}
    recorder.reset_counts()
    before = recorder.counts()
    try:
        for name, _, _, size in CASES_3D:
            recorder.install(recs[name])
            builds = COUNTS['builds.schedule']
            t0 = time.perf_counter()
            frames[name] = render3d(tapes[name], mat=mats[name], size=size)
            torch.cuda.synchronize()
            print(f"render3d {name} @{size}^3: "
                  f"{time.perf_counter() - t0:.3f} s (first frame, host "
                  "clock)")
            now = recorder.counts()
            for kname, need in LAUNCHES_3D.items():
                got = now[kname] - before[kname]
                check(got >= need, f"kernel {kname} launched {got} times in "
                      f"the {name} frame, {need} expected")
            before = now
            # the frame's three launches of kernel A share one schedule
            lvs = [levels_of(k) for _, k, _ in recs[name]["interval_shorten"]]
            built = COUNTS['builds.schedule'] - builds
            check(built == 1 and all(lv is lvs[0] for lv in lvs),
                  f"the {name} frame built {built} schedules, or its "
                  "launches of kernel A do not share one")
            print_levels(name, lvs[0])
    finally:
        recorder.remove()
    launches["3d"] = recorder.counts()
    print(f"3D path launches over {len(CASES_3D)} frames: {launches['3d']}")
    ctx["recs3d"] = recs
    for name, *_ in CASES_3D:
        a, k, _ = recs[name]["voxel_eval_3d"][0]
        v = tk3.voxel_launch(k["s_cap"], a[8].shape[1])
        a, k, _ = recs[name]["deriv_eval_3d"][0]
        d = tk3.deriv_launch(k["s_cap"], a[7].shape[1], a[7].shape[0],
                             a[3].shape[0])
        results[name] = {"shapes": {"voxel_eval_3d": shape_label(v),
                                    "deriv_eval_3d": shape_label(d)}}
        print(f"launch shapes {name}: V {shape_label(v)} (s_cap "
              f"{k['s_cap']}, cap {a[7].shape[1]}); D {shape_label(d)} "
              f"({a[7].shape[0]} rows, full tape {a[3].shape[0]})")
    check(launches["3d"]["pixel_eval_runs"] == 0,
          "the 3D path launched the 2D pixel kernel")

    # with_normals=False returns the same depth and launches no kernel D
    name, _, _, size = CASES_3D[0]
    d_before = tk3.deriv_eval_3d.launches
    d2, none = render3d(tapes[name], mat=mats[name], size=size,
                        with_normals=False)
    check(none is None and np.array_equal(d2, frames[name][0]),
          "with_normals=False changed the depth")
    check(tk3.deriv_eval_3d.launches == d_before,
          "with_normals=False launched kernel D")

    # ---- kernels vs plain, depth vs the dense reference, normals -------------
    for i, (name, _, _, size) in enumerate(CASES_3D):
        depth, normals = frames[name]
        a_v = recs[name]["voxel_eval_3d"][0][0]
        print(f"image {name} @{size}^3: covered fraction "
              f"{(depth > 0).mean():.6f}, {a_v[2].numel()} of "
              f"{(size // 64) ** 3} tiles and {int(a_v[0][0])} of "
              f"{(size // 16) ** 3} cells ambiguous after the culls")
        keep = ctx.setdefault("plain3d", {})[name] = {}
        res = compare_kernels_3d(tk, tk3, recs[name], tapes[name], name,
                                 keep)
        results[name].update(res)
        for kname, r in res.items():
            for j, rr in enumerate(r if isinstance(r, list) else [r]):
                check(rr["mismatches"] == 0, f"{kname} (launch {j}) "
                      f"disagrees with its plain version in {name} "
                      f"({rr['mismatches']} mismatches)")
        t0 = time.perf_counter()
        want = render3d_brute(tapes[name], mat=mats[name], size=size)
        ctx.setdefault("brute3d", {})[name] = want
        bad = depth != want
        print(f"  depth vs render3d_brute @{size}^3: {int(bad.sum())} pixels "
              f"differ ({time.perf_counter() - t0:.1f} s of dense "
              "evaluation)")
        check(depth.shape == (size, size) and depth.dtype == np.int32,
              "depth has the wrong shape or type")
        check(not bad.any(), f"depth differs from the dense evaluation in "
              f"{name}")
        check(0.0 < (depth > 0).mean() < 1.0, "depth all empty or all set")
        td = TapeData.from_tape(tapes[name], device=dev)
        e_len, e_ad = check_normals(eval_scan, camera, td,
                                    torch.as_tensor(mats[name], device=dev),
                                    depth, normals, size, 95 + i)
        print(f"  normals {name}: | |n| - 1 | <= {e_len:.2e} where depth > 0,"
              f" zero elsewhere; max |n - autograd| on 256 pixels {e_ad:.2e}")
    torch.cuda.synchronize()

    # ---- timing ----------------------------------------------------------------
    for name, _, _, size in CASES_3D:
        rec, res = recs[name], results[name]
        td = TapeData.from_tape(tapes[name], device=dev)
        mat_t = torch.as_tensor(mats[name], device=dev)
        n = size // 64

        def frame(normals=True):
            return pipeline3d.render3d_rows(td, mat_t, size, 0, n, normals)
        frame()
        builds = COUNTS['builds.schedule']
        f_ms = cuda_ms(frame, 10, 2)
        check(COUNTS['builds.schedule'] == builds, "a 3D frame after the "
              "first on one tape built a schedule")
        f0_ms = cuda_ms(lambda: frame(False), 10, 2)
        t0 = time.perf_counter()
        for _ in range(5):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 200
        print(f"frame {name} @{size}^3: {f_ms:.3f} ms with normals, "
              f"{f0_ms:.3f} ms without (events, median of 10); "
              f"{wall_ms:.3f} ms (host clock, mean of 5)  [{card}]")
        for kname, mod in (("voxel_eval_3d", tk3), ("deriv_eval_3d", tk3)):
            a, k, _ = rec[kname][0]
            fn = getattr(mod, kname)
            plain = getattr(mod, kname + "_plain")
            r = res[kname]
            r["ms"] = cuda_ms(lambda: fn(*a, **k), 30, 3)
            r["device_ms"] = device_ms(lambda: fn(*a, **k))
            r["plain_ms"] = plain_ms(lambda: plain(*a, **k))
            print(f"  {kname} {r['ms']:.4f} ms (device {r['device_ms']}) "
                  f"over {r['rows']} rows; plain {r['plain_ms']:.1f} ms  "
                  f"[{card}]")
        for kname in ("interval_shorten", "compact_bitshift_batched"):
            fn = getattr(tk, kname)
            plain = getattr(tk, kname + "_plain")
            for (a, k, _), r in zip(rec[kname], res[kname]):
                r["ms"] = cuda_ms(lambda: fn(*a, **k), 30, 3)
                r["device_ms"] = device_ms(lambda: fn(*a, **k))
                r["plain_ms"] = plain_ms(lambda: plain(*a, **k))
            print(f"  {kname} per launch: "
                  + ", ".join(f"{r['ms']:.4f}" for r in res[kname])
                  + " ms (device "
                  + ", ".join(f"{r['device_ms']}" for r in res[kname])
                  + "); plain "
                  + ", ".join(f"{r['plain_ms']:.1f}" for r in res[kname])
                  + f" ms  [{card}]")
        for stage, r in zip(("cells", "columns"),
                            res["compact_bitshift_batched"]):
            print_c_share(f"{name} {stage}", r, card)
        res["prepass"] = time_prepass(frame, card, f"{name} @{size}^3")
        print_profile(f"{name} @{size}^3", frame, card, 3)
    name = CASES_3D[0][0]
    ctx["frame3d"] = dict(name=name, size=CASES_3D[0][3], frame=frames[name])
    ctx["frames3d"] = frames


def masked_same(a, b, lens):
    """Mismatches of two (rows, width) tensors over ``[0, lens[row])`` of
    each row, floats compared by their bits."""
    import torch
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    k = torch.arange(a.shape[1], device=a.device)
    m = k[None, :] < lens[:, None]
    return int(((a != b) & m).sum())


def c1_mismatches(got, want, n):
    """Kernel C1's mismatches against the plain output over what it
    specifies, rows below ``n``: gmeta's [len, n_runs, overflow], each tape
    over [0, len) and the headers over [0, n_runs)."""
    import torch
    gm = got[3][:n]
    ln, nr = gm[:, 0], torch.clamp(gm[:, 1], max=got[2].shape[1])
    return dict(gmeta=same(gm[:, :3], want[3][:n, :3])[0],
                tw=masked_same(got[0][:n], want[0][:n], ln),
                ti=masked_same(got[1][:n], want[1][:n], ln),
                runs=masked_same(got[2][:n], want[2][:n], nr))


# Forced launch shapes of phase 9, as keyword arguments of pixel_v1_launch
# (B1: each home at K = 1, 2, 4, P = 1, 4, 16 and 64, no tape staged) and
# compact_runs_launch (C1: a warp a row at 1, 8 and 32 rows a block, a
# block a row at 128 to 1024 threads); the ragged and long-tape cases take
# a few of B1's.  Shapes that do not fit are printed as refused.
EDGE_B1 = ([dict(home=h, k=kk) for h in ("shared", "local")
            for kk in (1, 2, 4)]
           + [dict(home="local", k=2, parts=p) for p in (1, 4, 64)]
           + [dict(home="local", k=2, threads=128, parts=16)]
           + [dict(home="local", stage=False),
              dict(home="shared", k=4, stage=False)])
EDGE_B1_FEW = [dict(home="local", k=kk) for kk in (1, 2, 4)] + [
    dict(home="shared", k=4)]
EDGE_C1 = ([dict(warp=True, threads=t) for t in (32, 256, 1024)]
           + [dict(warp=False, threads=t) for t in (128, 256, 512, 1024)])
# B1's ragged case: the first V1_RAGGED pixels of each tile; its long-tape
# case: the full stress_2d(1500) tape on V1_LONG_TILES tiles of the 2048^2
# frame, longer than the B1_STAGE clauses B1 stages (run also with the
# whole tape staged, a forced stage size)
V1_RAGGED = 1000
V1_LONG_TILES = 8
# Phase 9's aim: B1's and C1's device time at most this many times kernel
# B's and C's in the same run (printed as held or missed)
V1_AIM = 1.15


def b1_label(launch):
    return shape_label(launch) + f" staged={launch.staged}"


def run_v1(ctx, results, launches):
    """Phase 9: kernels B1, C1 and C2 on the recorded 1024^2 frame, B1 and
    C1 at forced shapes, B1 at a ragged P and on a tape too long to stage,
    C1 on the gyroid's short planes."""
    import numpy as np
    import torch
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import pipeline2d
    tk, card, recorder = ctx["tk"], ctx["card"], ctx["rec"]
    f = ctx["frame2d"]
    rec, tape, size = f["rec"], f["tape"], f["size"]
    (meta, words, imms, _), _, (status, codes) = rec["interval_shorten"][0]
    (cmeta_c, lens_c, wrw_r, irw_r, rem_r), kc, out_c = \
        rec["compact_bitshift_batched"][0]
    a_b, k_b, fill = rec["pixel_eval_runs"][0]
    nmeta_b, order, coords = a_b[0], a_b[1], a_b[11]
    dev = codes.device
    n_tiles, tcap = codes.shape[0], words.shape[0]
    n = int(cmeta_c[0])
    cap8 = out_c[0].shape[1]
    P = coords.shape[2]
    # the frame's own branch numbering, so that C1's run headers can be
    # held against kernel C's where the tapes are equal
    remap_t = torch.zeros(32, dtype=torch.int32, device=dev)
    table = tk.bid_table(a_b[6])
    for bid, op in enumerate(table.tolist()):
        if op:
            remap_t[op] = bid
    tiles = order[:n].long()

    def cmeta(*vals):
        m = torch.zeros(8, dtype=torch.int32, device=dev)
        m[:len(vals)] = torch.tensor(vals, dtype=torch.int32)
        return m

    # the frame's capacity, and half of it so that some tapes overflow
    caps = (tcap, cap8, cap8 // 2)
    c1_args = {cap: (cmeta(n, tcap // 8, cap), words, imms, order, remap_t,
                     codes, n_tiles, cap, cap) for cap in caps}
    # the prepass planes back in TILE order, as C2 reads them
    planes_t = []
    for p in (wrw_r, irw_r, rem_r):
        t = torch.empty_like(p)
        t[order.long()] = p
        planes_t.append(t)
    lens_t = torch.empty_like(lens_c)
    lens_t[order.long()] = lens_c
    c2_args = (cmeta(n, cap8, cap8), order, lens_t, *planes_t, n_tiles, cap8,
               cap8)

    def b1_args(c1_out):
        tw, ti, _, gmeta = c1_out
        w_t, i_t = torch.zeros_like(tw), torch.zeros_like(ti)
        l_t = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
        w_t[tiles], i_t[tiles], l_t[tiles] = tw[:n], ti[:n], gmeta[:n, 0]
        nm = nmeta_b.clone()
        nm[0] = n
        nm[6] = 0
        return (nm, order, l_t, w_t, i_t, coords)

    s_cap = k_b["s_cap"]

    # ---- the drive: every count at 0, the chain once, the counts read ------
    recorder.reset_counts()
    c1 = {cap: tk.compact_runs(*c1_args[cap]) for cap in caps}
    args_b1 = b1_args(c1[tcap])
    vals = tk.pixel_eval(*args_b1, s_cap=s_cap)
    c2 = tk.compact_bitshift(*c2_args)
    torch.cuda.synchronize()
    counts = recorder.counts()
    launches["v1"] = counts
    print(f"kernel phase launches: "
          f"{ {k: counts[k] for k in KERNELS_V1} }")
    for name in KERNELS_V1:
        check(counts[name] >= 1, f"kernel {name} was not launched by the "
              "kernel phase")
    c1_shape = ln.compact_runs_launch(tcap, tcap, n_tiles)
    b1_shape = ln.pixel_v1_launch(s_cap, tcap, n_tiles, P)
    print(f"  launch shapes: C1 {c_label(c1_shape)} at cap {tcap}; B1 "
          f"{b1_label(b1_shape)}")

    res = results["v1"] = {}
    # ---- C1 against its plain version ---------------------------------------
    mism, kept, plain_c1 = 0, {}, {}
    for cap in caps:
        got = c1[cap]
        want = plain_c1[cap] = tk.compact_runs_plain(*c1_args[cap])
        gm = got[3][:n]
        m = c1_mismatches(got, want, n)
        kept[cap] = (int(gm[:, 0].sum()),
                     int(torch.clamp(gm[:, 1], max=cap).sum()))
        print(f"  C1 compact_runs cap {cap}: {n} groups, mean len "
              f"{kept[cap][0] / max(n, 1):.1f} of {tape.length}, longest "
              f"{int(gm[:, 0].max())}, {int(gm[:, 2].sum())} flagged; "
              f"mismatches {m}")
        mism += sum(m.values())
    # and against the frame: at cap = Tcap the lengths are the prepass's
    # (kernel A's codes are zero past the tape) and the run headers kernel
    # C's, on the rows C did not flag
    gm_c = out_c[3][:n]
    fits = gm_c[:, 2] == 0
    gm1 = c1[tcap][3][:n]
    check(bool((gm1[:, 0] == lens_c[:n]).all()),
          "C1's lengths differ from the prepass's")
    check(bool((gm1[fits][:, 1] == gm_c[fits][:, 1]).all())
          and masked_same(c1[tcap][2][:n][fits][:, :cap8],
                          out_c[2][:n][fits], gm_c[fits][:, 1]) == 0,
          "C1's run headers differ from kernel C's")
    print(f"  C1 at cap {tcap} against the frame: lengths equal to the "
          f"prepass's on {n} rows, run headers equal to kernel C's on "
          f"{int(fits.sum())} unflagged rows")
    for cap in caps[1:]:
        gm = c1[cap][3][:n]
        check(bool(((lens_c[:n] >= cap) == (gm[:, 2] == 1)).all())
              and bool((gm[:, 0] == torch.clamp(lens_c[:n], max=cap)).all()),
              f"C1 at cap {cap}: len is not min(count, cap) or the flag is "
              "not count >= cap")
    check(bool(c1[caps[-1]][3][:n, 2].any()),
          f"no tape overflowed cap {caps[-1]}")
    k_len, k_runs = kept[tcap]
    res["compact_runs"] = dict(
        mismatches=mism, max_abs_err=0.0,
        bytes=8 * tape.length + 4 * n * (tcap // 8) + 4 * n + 128 + 32
        + 8 * k_len + 4 * k_runs + 32 * n, ops=0)

    # ---- B1 against its plain version and the frame's fill -----------------
    pvals = tk.pixel_eval_plain(*args_b1, s_cap=s_cap)
    n_b1, e_b1 = same(vals[:n], pvals[:n])
    ok_rows = gm1[:, 2] == 0
    fill_rows = fill[tiles] > 0
    n_sign = int(((vals[:n] < 0) != fill_rows)[ok_rows].sum())
    print(f"  B1 pixel_eval: {n} groups x {P} pixels, value mismatches "
          f"{n_b1} (max |err| {e_b1:.3g}); signs against the frame's fill "
          f"on {int(ok_rows.sum())} unflagged tiles: {n_sign} differ")
    lut = np.zeros(256, np.int64)
    for o, c in FLOAT_OPS.items():
        lut[o] = c
    tw_h = c1[tcap][0][:n].cpu().numpy()
    ln_h = gm1[:, 0].cpu().numpy()
    per_px = sum(int(lut[tw_h[g, :ln_h[g]] & 0xFF].sum()) for g in range(n))
    res["pixel_eval"] = dict(
        mismatches=n_b1 + n_sign, max_abs_err=e_b1,
        bytes=n * 3 * P * 4 + n * P * 4 + 8 * k_len + 8 * n + 32,
        ops=P * per_px)

    # ---- C2 against its plain version and kernel C --------------------------
    want = tk.compact_bitshift_plain(*c2_args)
    m = {}
    for nm, g, w, c in zip(("tw", "ti", "runs"), c2[:3], want[:3], out_c[:3]):
        m[nm] = same(g[:n], w[:n])[0] + same(g[:n], c[:n])[0]
    m["gmeta"] = (same(c2[3][:n, :3], want[3][:n, :3])[0]
                  + same(c2[3][:n, :3], out_c[3][:n, :3])[0])
    print(f"  C2 compact_bitshift: {n} groups; mismatches against the plain "
          f"version and kernel C {m}")
    kept_c = int(out_c[3][:n, 0].sum())
    res["compact_bitshift"] = dict(
        mismatches=sum(m.values()), max_abs_err=0.0,
        bytes=4 * n * tcap + 8 * kept_c + 8 * n + n * (12 * cap8 + 32),
        ops=0)
    for name, r in res.items():
        check(r["mismatches"] == 0, f"{name} disagrees with its plain "
              f"version or the frame ({r['mismatches']} mismatches)")

    # ---- timing ---------------------------------------------------------------
    timed = (("compact_runs", lambda: tk.compact_runs(*c1_args[tcap]),
              lambda: tk.compact_runs_plain(*c1_args[tcap])),
             ("pixel_eval", lambda: tk.pixel_eval(*args_b1, s_cap=s_cap),
              lambda: tk.pixel_eval_plain(*args_b1, s_cap=s_cap)),
             ("compact_bitshift", lambda: tk.compact_bitshift(*c2_args),
              lambda: tk.compact_bitshift_plain(*c2_args)))
    for name, fn, plain in timed:
        res[name]["ms"] = cuda_ms(fn, 30, 3)
        res[name]["device_ms"] = device_ms(fn, tries=3)
        res[name]["plain_ms"] = plain_ms(plain)
    res["compact_runs"]["ms_cap8"] = cuda_ms(
        lambda: tk.compact_runs(*c1_args[cap8]), 30, 3)

    def frame_c():
        return tk.compact_bitshift_batched(cmeta_c, lens_c, wrw_r, irw_r,
                                           rem_r, **kc)

    def frame_b():
        return tk.pixel_eval_runs(*a_b, **k_b)
    c_ms, b_ms = cuda_ms(frame_c, 30, 3), cuda_ms(frame_b, 30, 3)
    c_dev = device_ms(frame_c, tries=3)
    b_dev = device_ms(frame_b, tries=3)
    td = TapeData.from_tape(tape, device=dev)
    eye = torch.eye(3, device=dev)
    z = torch.tensor(0.0, device=dev)
    pre = time_prepass(
        lambda: pipeline2d.render_tile_block(td, eye, z, size), card,
        f"@{size}^2", pipeline2d)
    res["compact_runs"]["kernel_c_device_ms"] = c_dev
    res["compact_runs"]["prepass"] = pre
    res["pixel_eval"]["kernel_b_device_ms"] = b_dev
    print(f"kernel phase @{size}^2: C1 {res['compact_runs']['ms']:.4f} ms at "
          f"cap {tcap}, {res['compact_runs']['ms_cap8']:.4f} ms at cap "
          f"{cap8}; B1 {res['pixel_eval']['ms']:.4f} ms (kernel B beside it "
          f"{b_ms:.4f}); C2 {res['compact_bitshift']['ms']:.4f} ms (kernel "
          f"C beside it {c_ms:.4f}); device C1 "
          f"{res['compact_runs']['device_ms']}, B1 "
          f"{res['pixel_eval']['device_ms']}, C2 "
          f"{res['compact_bitshift']['device_ms']} ms; plain "
          + ", ".join(f"{res[k]['plain_ms']:.1f}" for k in
                      ("compact_runs", "pixel_eval", "compact_bitshift"))
          + f" ms  [{card}]")
    for name, kname, other in (("compact_runs", "C", c_dev),
                               ("pixel_eval", "B", b_dev)):
        d = res[name]["device_ms"]
        ratio = d / other if d and other else None
        first = PREVIOUS_DESIGN_MS[name][f"stress_2d({CASES[0][0]}) "
                                         f"{size}^2"]
        res[name]["vs_kernel"] = ratio
        print(f"  {name} device {d} ms against kernel {kname}'s {other} ms "
              f"in this run: "
              + (f"{ratio:.3f}x, aim <= {V1_AIM}x: "
                 + ("held" if ratio <= V1_AIM else "MISSED")
                 if ratio is not None else "not measured")
              + f"; first design {first} ms (recorded); bound "
              f"{bound(res[name])[0]:.5f} ms ({bound(res[name])[1]})"
              f"  [{card}]")
    pdev = pre["device_ms"]
    print(f"  prepass + C @{size}^2: "
          + (f"{pdev:.4f} + {c_dev} = {pdev + c_dev:.4f} ms device"
             if pdev is not None and c_dev is not None else "not measured")
          + f" against C1's {res['compact_runs']['device_ms']} ms (C1 needs "
          f"no prepass)  [{card}]")

    # ---- B1 and C1 at forced shapes, B1 ragged and unstaged ----------------
    sweep = results["v1_sweep"] = []
    cell = f"stress_2d({CASES[0][0]}) {size}^2 kernel phase"

    def b1_sweep(label, args, sc, kws, want=None):
        gcap, cap, pix = args[1].shape[0], args[3].shape[1], args[5].shape[2]
        nr = int(args[0][0])
        if want is None:
            want = tk.pixel_eval_plain(*args, s_cap=sc)
        shapes = forced(lambda: ln.pixel_v1_launch(sc, cap, gcap, pix),
                        lambda **kw: ln.pixel_v1_launch(sc, cap, gcap, pix,
                                                        **kw), kws)
        sweep_one(label, "pixel_eval", tk.pixel_eval, args, {"s_cap": sc},
                  shapes, lambda out: bit_mismatches(out[:nr], want[:nr]),
                  b1_label, sweep, card)
        return shapes

    # and the frame's tapes with all cap clauses staged (a forced stage
    # size): the shared memory that a long tape staged whole asks for
    b1_sweep(cell, args_b1, s_cap, EDGE_B1 + [dict(home="local", stage=tcap)],
             pvals)
    ragged = args_b1[:5] + (coords[:, :, :V1_RAGGED].contiguous(),)
    b1_sweep(f"{cell}, P={V1_RAGGED}", ragged, s_cap, EDGE_B1_FEW)
    # a tape past B1_STAGE: the full stress_2d(1500) tape on tiles of the
    # 2048^2 frame
    rec2 = ctx["recs2d"][CASES[1][1]]
    (meta2, words2, imms2, _), _, _ = rec2["interval_shorten"][0]
    a_b2, k_b2, _ = rec2["pixel_eval_runs"][0]
    length2, nt = int(meta2[0]), V1_LONG_TILES
    nm_l = a_b2[0].clone()
    nm_l[0] = nt
    nm_l[6] = 0
    long_args = (nm_l, torch.arange(nt, dtype=torch.int32, device=dev),
                 torch.full((nt,), length2, dtype=torch.int32, device=dev),
                 words2[None].expand(nt, -1).contiguous(),
                 imms2[None].expand(nt, -1).contiguous(),
                 a_b2[11][:nt].contiguous())
    check(length2 > ln.B1_STAGE, "the long tape fits B1's staging")
    # and the whole tape staged (a forced stage size past B1_STAGE), timed
    # beside the global-memory walk
    long_cell = f"stress_2d({CASES[1][0]}) full tape, {nt} tiles"
    shapes = b1_sweep(long_cell, long_args, k_b2["s_cap"],
                      EDGE_B1_FEW[:2] + [dict(home="local", stage=length2)])
    ran = [sh for _, sh in shapes if not isinstance(sh, str)]
    check(all(sh.staged < length2 for sh in ran[:-1])
          and ran[-1].staged == length2,
          "the long tape was staged, or its forced staging was refused")
    # sweep_one added a row for each shape that ran, the picked one first
    long_ms = res["pixel_eval"]["long_tape_device_ms"] = {
        "global": sweep[-len(ran)]["device_ms"],
        "staged": sweep[-1]["device_ms"]}
    print(f"  B1 on the full {length2}-clause tape (past its "
          f"{ln.B1_STAGE} staged clauses): read from global memory at "
          f"{len(ran) - 1} shapes; device ms, picked (global memory) "
          f"{long_ms['global']} against the whole tape staged "
          f"{long_ms['staged']}  [{card}]")
    # C1 at forced shapes on the frame, cap = Tcap
    shapes = forced(lambda: c1_shape,
                    lambda **kw: ln.compact_runs_launch(tcap, tcap, n_tiles,
                                                        **kw), EDGE_C1)
    sweep_one(cell, "compact_runs", tk.compact_runs, c1_args[tcap], {},
              shapes,
              lambda out: sum(c1_mismatches(out, plain_c1[tcap], n).values()),
              c_label, sweep, card)
    # C1 on short planes: kernel A's codes of the gyroid frame's 16^3 stage
    name3 = CASES_3D[0][0]
    (meta3, words3, imms3, _), _, (st3, codes3) = \
        ctx["recs3d"][name3]["interval_shorten"][1]
    tcap3 = words3.shape[0]
    amb3 = st3 == tk.ST_AMBIG
    n3 = int(amb3.sum())
    order3 = torch.argsort((~amb3).to(torch.int32), stable=True).to(
        torch.int32)
    _, remap3 = tk.build_remap(tuple(range(2, 32)))
    c1_short = (cmeta(n3, tcap3 // 8, tcap3), words3, imms3, order3,
                torch.as_tensor(remap3, device=dev), codes3, codes3.shape[0],
                tcap3, tcap3)
    want3 = tk.compact_runs_plain(*c1_short)
    short = ln.compact_runs_launch(tcap3, tcap3, codes3.shape[0])
    check(short.group == 32 and tcap3 <= ln.C_WARP_TCAP,
          f"the gyroid's {tcap3}-clause planes did not take a warp a row")
    gm3 = want3[3][:n3]
    print(f"  C1 on {name3}'s 16^3 stage: {n3} ambiguous of "
          f"{codes3.shape[0]} cells, {tcap3}-clause planes, mean len "
          f"{float(gm3[:, 0].float().mean()):.1f} of {int(meta3[0])}")
    shapes = forced(lambda: short,
                    lambda **kw: ln.compact_runs_launch(
                        tcap3, tcap3, codes3.shape[0], **kw), EDGE_C1)
    sweep_one(f"{name3} 16^3 cells", "compact_runs", tk.compact_runs,
              c1_short, {}, shapes,
              lambda out: sum(c1_mismatches(out, want3, n3).values()),
              c_label, sweep, card)
    del want3
    torch.cuda.synchronize()


def run_cli(ctx, launches):
    """Phase 10: the command line, as a subprocess and once in process."""
    import tempfile
    import numpy as np
    from mpr_tpu_torch import cli
    from mpr_tpu_torch.frontend import frep, shapes
    from mpr_tpu_torch.io.png import read_png_gray
    from mpr_tpu_torch.render import camera, render3d
    import mpr_tpu_torch
    recorder = ctx["rec"]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        scene = shapes.intersection(shapes.gyroid(0.4, 0.08),
                                    shapes.sphere(0.85))
        frep.dump([frep.ArchiveShape(tree=scene, name="gyroid_sphere")],
                  os.path.join(tmp, "scene.frep"))

        def run(*argv):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli",
                                *argv], cwd=tmp, env=env,
                               capture_output=True, text=True, timeout=600)
            print(f"cli {' '.join(argv)}: exit {r.returncode}, "
                  f"{time.perf_counter() - t0:.1f} s")
            for line in r.stdout.strip().splitlines():
                print("    " + line)
            check(r.returncode == 0, f"cli {argv[0]} failed:\n{r.stderr}")
            return r.stdout

        n_blobs, size = CASES[0]
        out = run("render2d", f"stress:{n_blobs}", "--size", str(size),
                  "--check")
        check("oracle cross-check: mismatch 0.00e+00" in out,
              "render2d --check printed no exact cross-check")
        img = read_png_gray(os.path.join(tmp, "out_2d.png")) > 0
        check(np.array_equal(img, ctx["frame2d"]["image"]),
              "the command line's 2D image differs from render2d's")

        run("render3d", "scene.frep", "--size", "512", "--mode", "all",
            "--view", "gui")
        tape = mpr_tpu_torch.compile_tree(scene)
        depth, _ = render3d(tape, mat=camera.gui3d_view(), size=512)
        pngs = {s: read_png_gray(os.path.join(tmp, f"out_3d_{s}.png"))
                for s in ("depth", "ssao", "shaded")}
        check(os.path.getsize(os.path.join(tmp, "out_3d_norm.png")) > 1000,
              "no normals image")
        check(np.array_equal(pngs["depth"], cli._depth_to_u8(depth, 512)),
              "the command line's depth image differs from render3d's")
        m = depth > 0
        check(0.0 < m.mean() < 1.0 and not pngs["shaded"][~m].any()
              and pngs["shaded"][m].min() >= int(0.2 * 255),
              "the shaded image is not 0 off the shape and >= 0.2 on it")
        check(not pngs["ssao"][~m].any() and pngs["ssao"][m].mean() > 64,
              "the SSAO image is off")
        print(f"  render3d PNGs: covered {m.mean():.4f}, shaded in "
              f"[{pngs['shaded'][m].min()}, {pngs['shaded'][m].max()}] / "
              f"255 on the shape, mean SSAO {pngs['ssao'][m].mean():.1f}")

        out = run("render2d", os.path.join(ROOT, "examples", "text_demo.io"),
                  "--size", "512", "--check", "--out", "text.png")
        check("mismatch 0.00e+00" in out, "the .io scene is not exact")
        out = run("shorten-stats", f"stress:{n_blobs}", "--size", str(size))
        check("shortened lengths (ambiguous tiles)" in out,
              "shorten-stats printed no distribution")

        # in process, so that the launch counts can be read
        recorder.reset_counts()
        cli.main(["render2d", f"stress:{n_blobs}", "--size", str(size),
                  "--out", os.path.join(tmp, "p2.png")])
        cli.main(["render3d", os.path.join(tmp, "scene.frep"), "--size",
                  "512", "--mode", "shaded", "--view", "gui", "--out",
                  os.path.join(tmp, "p3.png")])
    counts = recorder.counts()
    launches["cli"] = counts
    print(f"command line launches (render2d + render3d in process): "
          f"{counts}")
    for name, _, *_ in KERNEL_ROWS:
        if name not in KERNELS_V1:
            check(counts[name] >= 1, f"the command line launched kernel "
                  f"{name} {counts[name]} times")


def run_effects(ctx):
    """Phase 11: SSAO and shading on the card against the CPU, and timed."""
    import torch
    from mpr_tpu_torch.render import effects
    card, dev = ctx["card"], ctx["dev"]
    f = ctx["frame3d"]
    depth_h, normals_h = f["frame"]
    depth = torch.as_tensor(depth_h, device=dev)
    normals = torch.as_tensor(normals_h, device=dev)
    rows = []
    for label, fn in (
            ("draw_ssao static", lambda d, n: effects.draw_ssao(
                d, n, mode="static")),
            ("draw_ssao gather", lambda d, n: effects.draw_ssao(
                d, n, mode="gather")),
            ("draw_shaded", effects.draw_shaded)):
        got = fn(depth, normals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn(depth.cpu(), normals.cpu())
        cpu_s = time.perf_counter() - t0
        d = (got.cpu() - want).abs()
        share = float((d > 1e-5).float().mean())
        far = float(d.max())
        ms = cuda_ms(lambda: fn(depth, normals), 5, 1)
        rows.append({"name": label, "at": f"{f['name']} {f['size']}^2",
                     "ms": ms, "max_abs_diff_vs_cpu": far,
                     "share_over_1e-5": share, "cpu_s": cpu_s})
        print(f"effects {label} @{f['size']}^2: {ms:.3f} ms on the card "
              f"(events, median of 5); against the CPU ({cpu_s:.1f} s "
              f"there): max |diff| {far:.3g}, {100 * share:.4f}% of pixels "
              f"over 1e-5  [{card}]")
        check(got.shape == depth.shape and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()), f"{label}: bad image")
        check(float(got.min()) >= 0.0 and float(got.max()) <= 1.0
              and not bool(got[depth == 0].any()), f"{label}: out of range")
        check(share <= EFFECT_SHARE and far <= EFFECT_FAR,
              f"{label}: the card and the CPU disagree")
    return rows


def bound(r):
    """(bound ms, what bounds it) from a result's bytes and operations."""
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = r["ops"] / PEAK_F32_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ptxas_rows(log):
    """(kernel, K, bucket, registers, stack bytes, spill stores, spill
    loads) for each instantiation of kernels B, B1, V, D and K2 in nvcc's
    -Xptxas -v output (bucket 0 is the shared home), of kernel A (K is 1
    with widening, 0 without; bucket 0), of kernels C, C2 and C1 (K is 1
    for a warp a row, 0 for a block a row; bucket 0) and of K2f (the walk
    ``scan_walk_kernel``: K its lanes a thread, bucket 1 where it stores
    the plan for K2, 0 for the plain walk; its first design
    ``scan_eval_first_kernel``: K 1 storing, 0 not; bucket 0)."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(voxel_eval_kernel|"
                      r"deriv_eval_kernel|pixel_eval_kernel|"
                      r"pixel_eval_v1_kernel)ILi(\d+)ELi(\d+)E", line)
        if m:
            cur = [m.group(1), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Function properties for \S*?(scan_adjoint_kernel)"
                      r"ILi(\d+)ELi(\d+)E", line)
        if m:
            cur = [m.group(1), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Function properties for \S*?(scan_walk_kernel)"
                      r"ILi(\d+)ELb(\d)E", line)
        if m:
            cur = [m.group(1), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Function properties for \S*?(interval_shorten_kernel|"
                      r"compact_kernel|compact_order_kernel|"
                      r"compact_runs_kernel|scan_eval_first_kernel)ILb(\d)E",
                      line)
        if m:
            cur = [m.group(1), int(m.group(2)), 0]
            continue
        if "Function properties for" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur += [int(m.group(1)), int(m.group(2)), int(m.group(3))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and len(cur) == 6:
            rows.append((cur[0], cur[1], cur[2], int(m.group(1)), *cur[3:]))
            cur = None
    return rows


def print_ptxas(tk3, logs):
    """Registers, stack frame and spills of every instantiation of A, B,
    B1, C, C2, C1, V, D, K2f and K2 in the libraries' nvcc logs
    (``{library: log}``; bucket 0: the files in shared memory; else local,
    or for D split by warps), each named with its shape and library.
    Every (kernel, K, bucket) of B, B1, V, D and K2 must be built, those
    of ``tk3.MAIN_K`` in the main library, and both of A's (with and
    without widening), C's, C2's and C1's (a warp or a block a row)
    and K2f's walk at every K of ``launch.SCAN_SWEEP``, storing the plan
    or not, in the main library (its first design, both ways, in the
    extra one).
    Returns the instantiations that spill: the run fails on them once every
    phase has run."""
    names = {"pixel_eval_kernel": "pixel_eval_runs",
             "pixel_eval_v1_kernel": "pixel_eval",
             "voxel_eval_kernel": "voxel_eval_3d",
             "deriv_eval_kernel": "deriv_eval_3d",
             "scan_adjoint_kernel": "scan_adjoint"}
    spills, built = [], {}
    for lib_name, log in sorted(logs.items()):
        for kern, k, bucket, regs, stack, st, ld in sorted(ptxas_rows(log)):
            built.setdefault((kern, k, bucket), set()).add(lib_name)
            if kern.startswith("interval"):
                shape = "widen" if k else "no widening"
            elif kern.startswith("compact"):
                shape = "a warp a row" if k else "a block a row"
            elif kern == "scan_eval_first_kernel":
                shape = "first design, " + ("storing the plan" if k
                                            else "plain walk")
            elif kern == "scan_walk_kernel":
                shape = f"K={k} " + ("storing the plan" if bucket
                                     else "plain walk")
            else:
                shape = f"K={k} " + ("shared" if bucket == 0 else (
                    f"local/split {bucket} slots" if kern.startswith("deriv")
                    else f"local {bucket} slots"))
            print(f"  ptxas [{lib_name}] {kern} {shape}: {regs} "
                  f"registers, {stack} B stack frame, {st} B spill stores, "
                  f"{ld} B spill loads")
            if st + ld:
                spills.append(f"{kern} K={k} bucket {bucket}")
    from mpr_tpu_torch.ops import launch as ln
    for kern, name in names.items():
        for k in (tk3.KS if name != "scan_adjoint" else ln.ADJ_KS):
            for bucket in (0,) + tk3.BUCKETS:
                want = ("main" if k == tk3.MAIN_K[name][bucket != 0]
                        else "extra")
                check(want in built.get((kern, k, bucket), ()),
                      f"{kern} K={k} bucket {bucket} is not in the {want} "
                      f"library (ptxas saw {sorted(built)})")
    for widen in (0, 1):
        check("main" in built.get(("interval_shorten_kernel", widen, 0), ()),
              f"kernel A (widen {widen}) is not in the main library")
    for kern in ("compact_kernel", "compact_order_kernel",
                 "compact_runs_kernel"):
        for warp in (0, 1):
            check("main" in built.get((kern, warp, 0), ()),
                  f"{kern} (warp a row {warp}) is not in the main library")
    for store in (0, 1):
        for k in sorted({sh.k for sh in ln.SCAN_SWEEP}):
            check("main" in built.get(("scan_walk_kernel", k, store), ()),
                  f"K2f K={k} (store {store}) is not in the main library")
        check("extra" in built.get(("scan_eval_first_kernel", store, 0), ()),
              f"K2f's first design (store {store}) is not in the extra "
              "library")
    return spills


# Forced launch shapes of phase 8b, as keyword arguments of voxel_launch
# and deriv_launch ("most" P: 4096 / (threads x K)); shapes that do not
# fit the cell are printed as refused and not run, and repeats are left
# out.
EDGE_V = ([dict(home="shared", k=kk) for kk in (1, 2, 4)]
          + [dict(home="shared", k=4, threads=128)]
          + [dict(home="local", k=kk, threads=t) for kk, t in
             ((1, 256), (1, 512), (2, 256), (2, 512), (4, 256))])
EDGE_D = ([dict(home=h, k=kk, parts=p) for h in ("shared", "local")
           for kk in (1, 2, 4) for p in (None, 1, "most")]
          + [dict(home="split", k=kk, threads=t, shared_warps=sw, parts=p)
             for kk, t, sw, p in ((1, 256, 1, None), (1, 256, None, None),
                                  (1, 256, None, 1), (1, 256, None, "most"),
                                  (1, 128, None, None), (2, 256, None, None))]
          + [dict(home="local", stage_full=False),
             dict(home="split", stage_full=False)])


def edge_shapes(tk3, kname, a, k):
    """(label, launch) for the forced shapes of phase 8b at one recorded
    launch of V or D; launch is the reason, a string, where the shape does
    not fit."""
    tw = a[8] if kname == "voxel_eval_3d" else a[7]
    gcap, cap = tw.shape
    s_cap = k["s_cap"]
    if kname == "voxel_eval_3d":
        return forced(lambda: tk3.voxel_launch(s_cap, cap),
                      lambda **kw: tk3.voxel_launch(s_cap, cap, **kw),
                      EDGE_V)
    tcap = a[3].shape[0]

    def deriv(**kw):
        if kw.get("parts") == "most":
            base = tk3.deriv_launch(s_cap, cap, gcap, tcap,
                                    **{**kw, "parts": None})
            kw["parts"] = 4096 // (base.threads * base.k)
        return tk3.deriv_launch(s_cap, cap, gcap, tcap, **kw)
    return forced(lambda: tk3.deriv_launch(s_cap, cap, gcap, tcap), deriv,
                  EDGE_D)


def bit_mismatches(a, b):
    """Elements whose float bits differ, NaNs in the same places equal."""
    import torch
    nan = torch.isnan(a) & torch.isnan(b)
    return int(((a.view(torch.int32) != b.view(torch.int32)) & ~nan).sum())


def shape_label(launch):
    return (f"{launch.home} threads={launch.threads} K={launch.k} "
            f"P={launch.blocks_per_row} smem={launch.smem}"
            + (f" shared_warps={launch.shared_warps}"
               if launch.home == "split" else "")
            + (f" bucket={launch.bucket}" if launch.bucket else "")
            + (" full-tape-staged" if launch.stage_full else ""))


# Forced launch shapes of kernels A and B in phase 8b, as keyword arguments
# of interval_launch and pixel_launch.
EDGE_A = ([dict(threads=t) for t in (32, 64, 128, 256, 512, 1024)]
          + [dict(threads=t, stage=True) for t in (256, 1024)]
          + [dict(threads=t, tiles=t, stage=st) for t in (64, 128, 256)
             for st in (True, False)])
EDGE_B = ([dict(home="local", k=kk) for kk in (1, 2, 4)]
          + [dict(home="local", k=2, parts=p) for p in (1, 2, 4, 8)]
          + [dict(home="local", k=2, threads=128, parts=16)]
          + [dict(home="shared", k=kk) for kk in (1, 2, 4)]
          + [dict(home="local", k=2, stage_full=st) for st in (True,
                                                               False)])


# Forced launch shapes of kernel C in phase 8b, as keyword arguments of
# compact_launch: a warp a row at 1, 4, 8 and 32 rows a block, a block a
# row at 128 to 1024 threads.
EDGE_C = ([dict(warp=True, threads=t) for t in (32, 128, 256, 1024)]
          + [dict(warp=False, threads=t) for t in (128, 256, 512, 1024)])


def c_label(launch):
    return (f"threads={launch.threads} "
            + ("a warp a row" if launch.group == 32 else "a block a row")
            + f" smem={launch.smem}")


def a_label(launch):
    return (f"threads={launch.threads} tiles={launch.tiles} smem="
            f"{launch.smem}" + (" staged" if launch.stage else ""))


def forced(picked, fn, kws):
    """(label, launch or the reason it was refused) for the picked shape
    and each forced one, repeats left out."""
    out = []
    for label, kw in [("picked", None)] + [(str(kw), kw) for kw in kws]:
        try:
            launch = picked() if kw is None else fn(**kw)
        except ValueError as e:
            out.append((label, str(e)))
            continue
        if all(launch != x for _, x in out):
            out.append((label, launch))
    return out


def sweep_one(cell, kname, fn, a, k, shapes, same_as_plain, label_of,
              sweep, card):
    """Run ``fn(*a, **k, launch=...)`` at each of ``shapes``, hold it
    against the plain output (``same_as_plain(out)`` counts mismatches),
    time it, and add a row to ``sweep``."""
    import torch
    for label, launch in shapes:
        if isinstance(launch, str):
            print(f"  edge {cell} {kname} {label:24.60s}: refused, does not "
                  f"fit ({launch})")
            continue
        got = fn(*a, **k, launch=launch)
        torch.cuda.synchronize()
        bad = same_as_plain(got)
        del got
        ms = cuda_ms(lambda: fn(*a, **k, launch=launch), 30, 3)
        dev = device_ms(lambda: fn(*a, **k, launch=launch))
        sweep.append({"kernel": kname, "label": label,
                      "shape": label_of(launch), "ms": ms,
                      "device_ms": dev, "mismatches": bad})
        print(f"  edge {cell} {kname} {label:24.60s} [{label_of(launch)}]: "
              f"{ms:.4f} ms (device {dev}), {bad} mismatches against plain"
              f"  [{card}]")
        check(bad == 0, f"{kname} at {label} ({label_of(launch)}) disagrees "
              f"with its plain version in {cell}")


def sweep_a(ctx, cell, entries, plains, sweep):
    """Kernel A at the forced shapes on each recorded launch."""
    from mpr_tpu_torch.ops import launch as ln
    tk = ctx["tk"]
    for (a, k, _), plain in zip(entries, plains):
        lv, lanes = levels_of(k), a[3].shape[1]

        def bad(out, plain=plain):
            n_st, n_codes, _ = a_mismatches(tk, out, plain)
            return n_st + n_codes
        shapes = forced(lambda: ln.interval_launch(lv.widths, lanes),
                        lambda **kw: ln.interval_launch(lv.widths, lanes,
                                                        **kw), EDGE_A)
        sweep_one(f"{cell} ({lanes} lanes)", "interval_shorten",
                  tk.interval_shorten, a, k, shapes, bad, a_label, sweep,
                  ctx["card"])


def sweep_c(ctx, cell, entries, plains, sweep):
    """Kernel C at the forced shapes on each recorded launch."""
    from mpr_tpu_torch.ops import launch as ln
    tk = ctx["tk"]
    for (a, k, _), plain in zip(entries, plains):
        G, R, W = a[2].shape
        n = int(a[0][0])
        args = (R * W, k["cap"], G)

        def bad(out, plain=plain, n=n):
            return sum(c_mismatches(out, plain, n)[0].values())
        shapes = forced(lambda: ln.compact_launch(*args),
                        lambda **kw: ln.compact_launch(*args, **kw), EDGE_C)
        sweep_one(f"{cell} ({n} rows)", "compact_bitshift_batched",
                  tk.compact_bitshift_batched, a, k, shapes, bad, c_label,
                  sweep, ctx["card"])


def run_edges(ctx, results):
    """Phase 8b: kernels V, D, A and C at forced launch shapes on the
    recorded inputs of both 3D cells, A, B and C on those of both 2D cells,
    each output against the plain output of phase 3 or 7, each shape
    timed."""
    import torch
    from mpr_tpu_torch.ops import launch as ln
    tk, tk3, card = ctx["tk"], ctx["tk3"], ctx["card"]
    for n_blobs, size in CASES:
        rec, res = ctx["recs2d"][size], results[size]
        sweep = res["sweep"] = []
        cell = f"stress_2d({n_blobs}) {size}^2"
        sweep_a(ctx, cell, rec["interval_shorten"],
                res["plain"]["interval_shorten"], sweep)
        a, k, _ = rec["pixel_eval_runs"][0]
        args = (k["s_cap"], a[7].shape[1], a[1].shape[0], a[3].shape[0])
        shapes = forced(lambda: ln.pixel_launch(*args),
                        lambda **kw: ln.pixel_launch(*args, **kw), EDGE_B)
        pfill = res["plain"]["pixel_eval_runs"]
        sweep_one(cell, "pixel_eval_runs", tk.pixel_eval_runs, a, k, shapes,
                  lambda out: int((out != pfill).sum()), shape_label, sweep,
                  card)
        sweep_c(ctx, cell, rec["compact_bitshift_batched"],
                res["plain"]["compact_bitshift_batched"], sweep)
        res["plain"] = None
    for name, *_ in CASES_3D:
        rec, plain = ctx["recs3d"][name], ctx["plain3d"][name]
        sweep = results[name]["sweep"] = []
        for kname in ("voxel_eval_3d", "deriv_eval_3d"):
            a, k, _ = rec[kname][0]
            n = int(a[0][0])
            sweep_one(name, kname, getattr(tk3, kname), a, k,
                      edge_shapes(tk3, kname, a, k),
                      lambda out: bit_mismatches(out[:n], plain[kname][:n]),
                      shape_label, sweep, card)
        sweep_a(ctx, name, rec["interval_shorten"],
                plain["interval_shorten"], sweep)
        sweep_c(ctx, name, rec["compact_bitshift_batched"],
                plain["compact_bitshift_batched"], sweep)
        ctx["plain3d"][name] = None
        torch.cuda.synchronize()


def unrolled_cells():
    """Phase 13's cells: (name, tape, mat or None, size), the first 2D
    cell and both 3D cells."""
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.render import camera
    n_blobs, size = CASES[0]
    cells = [(f"stress_2d({n_blobs})",
              mpr_tpu_torch.compile_tree(shapes.stress_2d(n_blobs)), None,
              size)]
    for name, make, view, size3 in CASES_3D:
        cells.append((name, mpr_tpu_torch.compile_tree(make(shapes)),
                      camera.gui3d_view(*view), size3))
    return cells


def forced_forms(cell, kind, first):
    """The forms phase 13 also runs a recorded launch of ``kind`` at:
    the serial form of the first design at every frame, and on a cell's
    first frame the sweep (``UNROLLED_SWEEP``)."""
    from mpr_tpu_torch.ops import launch as ln
    out = [ln.UnrolledLaunch("serial")]
    if first:
        out += [ln.UnrolledLaunch(f, k=v) if f == "lanes"
                else ln.UnrolledLaunch(f, parts=v)
                for f, v in UNROLLED_SWEEP.get(cell, {}).get(kind, ())]
    return out


def minmax_evals():
    """Float and interval evaluators of one min and one max clause (the
    probe of min.NaN / max.NaN against torch.minimum / maximum)."""
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.tape.tape import Tape
    out = []
    for op in (18, 20):            # MIN_LHS_RHS, MAX_LHS_RHS
        tape = Tape.from_arrays(ops=[op], outs=[4], lhss=[1], rhss=[2],
                                imms=[0.0], axis_slots=(1, 2, 3),
                                result_slot=4, num_slots=5, num_choices=1)
        out += [(op, ue.build_float(tape)), (op, ue.build_interval(tape))]
    return out


def start_unrolled_builds():
    """Start building phase 13's kernels in a thread, so that their nvcc
    processes run beside phase 1's: each evaluator's own forms (three
    cells x three semantics), the first design's serial form and the
    sweep's forms of each a cell's frames launch, and every form of the
    min/max probe."""
    import threading
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import unrolled
    cells = unrolled_cells()
    evals = [e for _, tape, _, _ in cells
             for r in [unrolled.get_renderer(tape)] for e in (r.fi, r.f, r.fd)]
    kernels = [k for e in evals for k in e.kernels()]
    for (cell, _, mat, _), trio in zip(cells, zip(*[iter(evals)] * 3)):
        # a 2D frame launches no deriv kernel: no first design to time
        kernels += [e.kernel(f) for e in trio
                    if mat is not None or e.kind != "deriv"
                    for f in forced_forms(cell, e.kind, True)]
    probe = minmax_evals()
    kernels += [k for _, ev in probe for k in ev.kernels()
                + [ev.kernel(ln.UnrolledLaunch("serial"))]]
    box = {"cells": cells, "evals": evals, "kernels": kernels,
           "probe": probe}

    def work():
        t0 = time.perf_counter()
        try:
            ue.build_all(kernels)
        except BaseException as e:       # re-raised by phase 13
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0
    box["thread"] = threading.Thread(target=work, daemon=True)
    box["thread"].start()
    return box


def gen_ops(src):
    """Float operations a lane of a generated kernel does (GEN_CALL_OPS),
    from its serial source."""
    import re
    n = 0
    for line in src.splitlines():
        m = re.match(r"\s*const float v\d+ = (.*);$", line)
        if not m:
            continue
        expr = m.group(1)
        call = re.match(r"(\w+)\(", expr)
        if call:
            n += GEN_CALL_OPS.get(call.group(1), 0)
        elif "?" not in expr and "[" not in expr and "__ldg" not in expr:
            n += 1       # a + b, a - b, a * b, a / b, -a
    return n


def bare_launch(ue, ev, args, imms, form=None):
    """``ev``'s kernel of ``form`` (default: the picker's) alone
    (``unrolled_eval._launch``, the launch the wrapper makes): the inputs
    flattened and the outputs allocated once, so that timing the returned
    closure times the launch and the kernel, not the wrapper's work
    around them (which ``wrapper_ms`` times).  Returns (closure, (lanes,
    outputs, imms): the tensors it reads and writes, to keep alive)."""
    import torch
    lanes = [t.reshape(-1).contiguous() for t in torch.broadcast_tensors(
        *args)]
    n = lanes[0].numel()
    outs = [torch.empty(n, dtype=torch.float32, device=lanes[0].device)
            for _ in range(ue.N_OUT[ev.kind])]

    def run():
        ue._launch(ev, lanes, imms, outs, form)
    return run, (lanes, outs, imms)


def ptxas_of(log):
    import re
    regs = re.findall(r"Used (\d+) registers", log)
    stack = re.findall(r"(\d+) bytes stack frame", log)
    spill = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       log)
    return (regs[-1] if regs else "?", stack[-1] if stack else "?",
            "/".join(spill[-1]) if spill else "?")


def sass_count(path):
    """Instructions (NOPs aside) of the kernels in a built library, from
    the toolkit's ``cuobjdump -sass``; None where it has none."""
    import re
    from mpr_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=600).stdout
    n = 0
    for line in out.splitlines():
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+([A-Z][^;]*);", line)
        if m and not m.group(1).startswith("NOP"):
            n += 1
    return n


def sm_clock_hz():
    """The SM clock the card reports as its maximum (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def first_design_spills(kind, form_tag):
    """The deriv kernel's serial first design, kept as the forms' yardstick
    (tape order keeps 500 values live: ptxas spills 112-120 B), is the one
    generated build the spill rule prints without failing."""
    return kind == "deriv" and form_tag == "serial"


def blocks_from_registers(regs, threads):
    """Resident blocks an SM of a kernel of ``threads`` a block at
    ``regs`` registers a thread, on an H100: 65,536 registers an SM,
    allocated 256 to a warp, at most 64 warps and 32 blocks; None where
    ptxas printed no count."""
    if not str(regs).isdigit():
        return None
    warps = threads // 32
    per_warp = -(-int(regs) * 32 // 256) * 256
    return min(32, 64 // warps, 65536 // (per_warp * warps))


def bits_differ(outs, pouts):
    """Values of ``outs`` whose bits differ from ``pouts``' (NaNs equal
    by NaN-ness)."""
    import torch
    n = 0
    for o, p in zip(outs, pouts):
        n += int(((o.view(torch.int32) != p.view(torch.int32))
                  & ~(torch.isnan(o) & torch.isnan(p))).sum())
    return n


def run_minmax_probe(probe, dev, forms_of):
    """min.NaN / max.NaN (lanes and split forms) and nmin / nmax (serial)
    against torch.minimum / maximum on every pair of +-0, +-inf, NaN, a
    subnormal and ordinary values: bit for bit, NaNs by NaN-ness."""
    import numpy as np
    import torch
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 1e-40,
                     -3.5, 2.5e38], np.float32)
    a, b = (torch.from_numpy(v.ravel().copy()).to(dev)
            for v in np.meshgrid(vals, vals))
    z = torch.zeros_like(a)
    for op, ev in probe:
        want = (torch.minimum if op == 18 else torch.maximum)(a, b)
        for form in forms_of(ev):
            got = (ev(a, b, z, launch=form) if ev.kind == "float"
                   else ev(a, a, b, b, z, z, launch=form))
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            bad = bits_differ(got, [want] * len(got))
            print(f"  min/max probe {'min' if op == 18 else 'max'} "
                  f"{ev.kind} {form.tag}: {a.numel()} pairs of +-0, +-inf, "
                  f"NaN, subnormal, ordinary; {bad} differ from torch's")
            check(bad == 0, f"{ev.kind} {form.tag} min/max differs from "
                  f"torch.minimum / maximum on special values")


def run_unrolled(ctx, results, launches, pre):
    """Phase 13: the unrolled engine (render/unrolled.py on the evaluators
    generated by ops/unrolled_eval.py)."""
    import numpy as np
    import torch
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.ops import unrolled_plan as up
    from mpr_tpu_torch.render import unrolled
    card, dev = ctx["card"], ctx["dev"]
    pre["thread"].join()
    if "error" in pre:
        raise pre["error"]
    cells, evals = pre["cells"], pre["evals"]
    clock = sm_clock_hz()
    print(f"unrolled engine: {len(pre['kernels'])} kernels built in "
          f"{pre['seconds']:.1f} s (their nvcc processes ran beside phase "
          f"1's and 14's; "
          f"{'held' if pre['seconds'] <= UNROLLED_BUILD_S else 'MISSED'}: at "
          f"most {UNROLLED_BUILD_S:.0f} s); the card's SM clock "
          f"{clock / 1e6:.0f} MHz  [{card}]")
    results["unrolled_build_s"] = round(pre["seconds"], 2)
    cell_of = {id(t): c for c, t, *_ in cells}
    facts, spills = {}, []
    for k in pre["kernels"]:
        b = ue.BUILDS[k.key]
        regs, stack, spill = ptxas_of(b["log"])
        form = getattr(k, "form", ln.UnrolledLaunch("serial"))
        cell = cell_of.get(id(k.tape), "min/max probe")
        f = dict(cell=cell, kind=k.kind, form=form.tag,
                 seconds=round(b["seconds"], 2), registers=regs, stack=stack,
                 spills=spill)
        sass = sass_count(ue._lib_path(k.key))
        f["sass_per_lane"] = None if sass is None else sass / form.k
        line = (f"  build {cell} {k.kind} {form.tag}: {k.tape.length} "
                f"clauses, {b['seconds']:.1f} s of nvcc"
                f"{'' if b['compiled'] else ' (earlier build, loaded)'}; "
                f"{regs} registers, {stack} B stack, spill stores/loads "
                f"{spill} B; SASS {f['sass_per_lane']} instructions a lane")
        prog = k.ev.program()
        f["live_peak_tape_order"] = order = up.live_peak(prog.stmts,
                                                         prog.outs)
        if form.form == "serial":
            f.update(blocks_per_sm=blocks_from_registers(
                regs, ln.UNROLLED_THREADS), block_threads=ln.UNROLLED_THREADS,
                live_peak=order)
            line += (f"; {f['blocks_per_sm']} blocks of "
                     f"{ln.UNROLLED_THREADS} an SM (from its registers); "
                     f"tape order: {order} values live at most")
        else:
            info = ue.kernel_info(k)
            f.update(blocks_per_sm=info["blocks_per_sm"],
                     block_threads=info["threads"])
            if form.form == "lanes":
                f["live_peak"] = up.live_peak(up.schedule(
                    prog.stmts, prog.outs), prog.outs)
                line += (f"; {info['blocks_per_sm']} blocks of "
                         f"{info['threads']} an SM; schedule: "
                         f"{f['live_peak']} values live at most (tape "
                         f"order {order})")
            else:
                sp = up.split(prog, form.parts)
                f["live_peak"] = max(
                    [up.live_peak(p.order, [n for n, _ in p.outs])
                     for p in sp.parts] + [up.live_peak(sp.top, sp.outs)])
                f.update(warps=sp.warps, top_clauses=len(sp.top_clauses),
                         longest=sp.longest(), duplicated=sp.duplicated(),
                         statements=len(prog.stmts))
                line += (f"; {info['blocks_per_sm']} blocks of "
                         f"{info['threads']} an SM; split: {sp.warps} warps,"
                         f" {len(sp.top_clauses)} top clauses, longest warp "
                         f"{sp.longest()} of {len(prog.stmts)} statements, "
                         f"{sp.duplicated()} computed twice, "
                         f"{f['live_peak']} values live at most in a part "
                         f"or the top (tape order {order})")
        print(line)
        facts[k.key] = f
        if spill != "0/0" and not first_design_spills(k.kind, form.tag):
            spills.append(f"{cell} {k.kind} {form.tag}: {spill} B")
    results["unrolled_spills"] = spills
    run_minmax_probe(pre["probe"], dev, lambda ev: [
        k.form for k in ev.kernels()] + [ln.UnrolledLaunch("serial")])

    # ---- the main path: each frame with every count at 0 ----------------------
    # A 3D cell renders twice, as a user's first two frames: the first takes
    # the full ladder (no counts yet), the second ("steady") the branch the
    # renderer picks from the first's counts (skip4 on gyroid_sphere).
    frames_of = []       # (label, cell, tape, mat, size, skip4)
    for cell, tape, mat, size in cells:
        frames_of.append((cell, cell, tape, mat, size, False))
        if mat is not None:
            frames_of.append((f"{cell} steady", cell, tape, mat, size, None))
    recorder = Recorder({"unrolled_eval": ue}, UNROLLED_ROWS)
    plain_calls = [0]
    real_plain = ue.UnrolledEval.plain

    def counted_plain(self, *a, **k):
        plain_calls[0] += 1
        return real_plain(self, *a, **k)
    recs, frames, per_frame = {}, {}, {}
    ue.UnrolledEval.plain = counted_plain
    try:
        for i, (label, cell, tape, mat, size, _) in enumerate(frames_of):
            r = unrolled.get_renderer(tape)
            if mat is not None:
                # the branch the renderer's decision will take
                skip4 = r._skip4_key(("3d", size))
                frames_of[i] = (label, cell, tape, mat, size, skip4)
            recs[label] = {}
            recorder.install(recs[label])
            recorder.reset_counts()
            t0 = time.perf_counter()
            if mat is None:
                frames[label] = unrolled.render2d(tape, size=size)
            else:
                frames[label] = unrolled.render3d(tape, mat=mat, size=size)
            torch.cuda.synchronize()
            per_frame[label] = recorder.counts()
            recorder.remove()
            if mat is None:
                need = UNROLLED_2D
            else:
                obs = r._obs[("3d", size)]
                need = {"unrolled_interval": 2 if skip4 else 3,
                        "unrolled_float": unrolled.voxel_launches(
                            obs[1], 16) if skip4
                        else unrolled.voxel_launches(obs[2], 4),
                        "unrolled_deriv": 1}
            branch = "" if mat is None else (
                " (skip4: 64^3 -> 16^3 -> voxels)" if skip4
                else " (full ladder: 64^3 -> 16^3 -> 4^3 -> voxels)")
            forms = {k: [a[0].launch((out[0] if isinstance(
                out, tuple) else out).numel()).tag
                for a, _, out in recs[label].get(k, [])]
                for k, *_ in UNROLLED_ROWS}
            print(f"unrolled {label} @{size}{branch}: "
                  f"{time.perf_counter() - t0:.3f} s (host clock); launches "
                  f"{per_frame[label]}, expected {need}; forms {forms}")
            for kname, n in need.items():
                check(per_frame[label][kname] == n, f"{kname} launched "
                      f"{per_frame[label][kname]} times in the unrolled "
                      f"{label} frame, {n} expected")
            # the forms the picker must take on the chip cells: both 2D
            # interval launches and the first of a full-ladder 3D frame
            # split, the extruded model's float launch and the normals in
            # lanes
            fi_forms = forms["unrolled_interval"]
            if mat is None:
                check(all(f.startswith("split") for f in fi_forms),
                      f"the 2D interval launches took {fi_forms}")
            elif label == cell:
                check(fi_forms[0].startswith("split"), f"the first "
                      f"interval launch of {label} took {fi_forms[0]}")
            if label == CASES_3D[1][0]:
                check(all(f.startswith("lanes")
                          for f in forms["unrolled_float"]),
                      f"the {label} float launch took "
                      f"{forms['unrolled_float']}")
            # the normals (237,568 and 724,992 lanes): the lanes form
            if mat is not None:
                check(all(f.startswith("lanes")
                          for f in forms["unrolled_deriv"]),
                      f"the {label} deriv launch took "
                      f"{forms['unrolled_deriv']}")
    finally:
        recorder.remove()
        ue.UnrolledEval.plain = real_plain
    check(plain_calls[0] == 0, f"the unrolled frames ran a plain evaluator "
          f"{plain_calls[0]} times")
    check(any(f[5] for f in frames_of), "no unrolled 3D frame took skip4")
    launches["unrolled"] = {k: sum(c[k] for c in per_frame.values())
                            for k, *_ in UNROLLED_ROWS}
    launches["unrolled_per_frame"] = per_frame
    print(f"unrolled path launches over {len(frames_of)} frames: "
          f"{launches['unrolled']}")

    # ---- every launch against its plain version, at its own form, the
    # first design's and the sweep's; images; timing -----------------------
    rows = {k: {} for k, *_ in UNROLLED_ROWS}
    frame_ms, sweep = {}, {}
    for label, cell, tape, mat, size, skip4 in frames_of:
        for kname, *_ in UNROLLED_ROWS:
            for j, (a, k, out) in enumerate(recs[label].get(kname, [])):
                ev, args = a[0], a[1:]
                pout = ev.plain(*args, imms=k.get("imms"))
                outs = out if isinstance(out, tuple) else (out,)
                pouts = pout if isinstance(pout, tuple) else (pout,)
                n_bad = bits_differ(outs, pouts)
                err = max(same(o, p)[1] for o, p in zip(outs, pouts))
                lanes = outs[0].numel()
                form = ev.launch(lanes)
                rr = dict(lanes=lanes, clauses=tape.length,
                          mismatches=n_bad, max_abs_err=err,
                          form=form.tag, forced={},
                          bytes=lanes * 4 * (ue.N_IN[ev.kind]
                                             + ue.N_OUT[ev.kind]),
                          ops=lanes * gen_ops(ev.source(
                              ln.UnrolledLaunch("serial"))))
                fk = facts.get(ev.kernel(form).key, {})
                if fk.get("sass_per_lane"):
                    rr["sass_per_lane"] = fk["sass_per_lane"]
                    rr["issue_floor_ms"] = (fk["sass_per_lane"] * lanes
                                            / (ln.SM_COUNT * 4 * 32 * clock)
                                            * 1e3)
                rr["registers"] = fk.get("registers")
                rows[kname].setdefault(label, []).append(rr)
                print(f"  {kname} {label} launch {j}: {lanes} lanes x "
                      f"{tape.length} clauses, {form.tag}, {n_bad} bits "
                      f"differ from the plain version, max |err| {err:.3g}")
                check(n_bad == 0, f"{kname} differs from its plain version "
                      f"in {label} (launch {j}): {n_bad} values")
                for f in forced_forms(cell, ev.kind, label == cell):
                    if f == form:
                        continue
                    run, keep = bare_launch(ue, ev, args, k.get("imms"), f)
                    run()
                    torch.cuda.synchronize()
                    bad = bits_differ(keep[1], pouts)
                    rr["forced"][f.tag] = {"mismatches": bad}
                    check(bad == 0, f"{kname} at the forced form {f.tag} "
                          f"differs from its plain version in {label} "
                          f"(launch {j}): {bad} values")
                    del keep
                del pout, pouts
        if mat is None:
            img = frames[label]
            for what, want in (("render2d_brute", ctx["brute2d"][size]),
                               ("the interpreter engine",
                                ctx["images2d"][size])):
                bad = int((img != want).sum())
                print(f"  unrolled image {label} vs {what}: {bad} pixels "
                      "differ")
                check(bad == 0, f"the unrolled {label} image differs from "
                      f"{what}")
        else:
            depth, normals = frames[label]
            idepth, inormals = ctx["frames3d"][cell]
            for what, want in (("render3d_brute", ctx["brute3d"][cell]),
                               ("the interpreter engine", idepth)):
                bad = int((depth != want).sum())
                print(f"  unrolled depth {label} vs {what}: {bad} pixels "
                      "differ")
                check(bad == 0, f"the unrolled {label} depth differs from "
                      f"{what}")
            m = depth > 0
            nerr = float(np.abs(normals - inormals).max())
            lnorm = np.linalg.norm(normals[m], axis=-1)
            print(f"  unrolled normals {label}: max |n - interpreter's| "
                  f"{nerr:.2e}, | |n| - 1 | <= {np.abs(lnorm - 1).max():.2e}")
            check(nerr <= 1e-4 and not normals[~m].any(),
                  f"the unrolled {label} normals differ from the "
                  "interpreter's")
        torch.cuda.synchronize()

        # the frame on the branch checked above, then each of its launches
        r = unrolled.get_renderer(tape)
        if mat is None:
            eye = torch.eye(3, device=dev)
            z = torch.tensor(0.0, device=dev)
            frame = (lambda: r.frame2d(eye, z, size))
            reps, branch = 20, ""
        else:
            mat_t = torch.as_tensor(mat, device=dev)
            frame = (lambda: r.frame3d(mat_t, size, skip4=skip4))
            reps = 10
            branch = " skip4" if skip4 else " full ladder"
        frame_ms[label] = cuda_ms(frame, reps, 2)
        # the same frame with the float and interval kernels at their first
        # design's form, in turns with the new one
        serial = ln.UnrolledLaunch("serial")
        for ev in (r.f, r.fi, r.fd):
            ev.launch = lambda n: serial
        try:
            first_ms = cuda_ms(frame, reps, 2)
        finally:
            del r.f.launch, r.fi.launch, r.fd.launch
        again = cuda_ms(frame, reps, 2)
        frame_ms[f"{label} first design"] = first_ms
        print(f"unrolled frame {label} @{size}{branch}: "
              f"{frame_ms[label]:.3f} ms, then {first_ms:.3f} with the "
              f"float, interval and deriv kernels at the first design's "
              f"form, then {again:.3f} (events, median of {reps} each)  "
              f"[{card}]")
        for kname, *_ in UNROLLED_ROWS:
            fn = recorder.originals[kname]
            for (a, k, _), rr in zip(recs[label].get(kname, []),
                                     rows[kname].get(label, [])):
                run, keep = bare_launch(ue, a[0], a[1:], k.get("imms"))
                rr["ms"] = cuda_ms(run, 10, 2)
                rr["wrapper_ms"] = cuda_ms(lambda: fn(*a, **k), 10, 2)
                rr["device_ms"] = device_ms(run, 5, "mpr_unrolled_kernel", 5)
                del keep
                rr["plain_ms"] = plain_ms(lambda: a[0].plain(
                    *a[1:], imms=k.get("imms")))
                rr["rate"] = rr["lanes"] * rr["clauses"] / rr["ms"] / 1e9
                rr["bound_ms"], rr["bound_by"] = bound(rr)
                for tag, fr in rr["forced"].items():
                    f = next(x for x in forced_forms(cell, a[0].kind, True)
                             if x.tag == tag)
                    run, keep = bare_launch(ue, a[0], a[1:], k.get("imms"),
                                            f)
                    fr["ms"] = cuda_ms(run, 10, 2)
                    fr["device_ms"] = device_ms(run, 5, "mpr_unrolled_kernel",
                                                5)
                    del keep
                floor = rr.get("issue_floor_ms")
                print(f"  {kname} {label}: {rr['lanes']} lanes, {rr['form']}"
                      f", {rr['ms']:.4f} ms (events around the bare launch; "
                      f"device {rr['device_ms']}; through the wrapper "
                      f"{rr['wrapper_ms']:.4f}), plain {rr['plain_ms']:.1f} "
                      f"ms, bound {rr['bound_ms']:.5f} ms ({rr['bound_by']})"
                      f", issue floor "
                      f"{'not measured' if floor is None else f'{floor:.5f}'}"
                      f" ms; {rr['rate']:.3f} T lane-clauses/s; forced "
                      + ", ".join(f"{t} {x['ms']:.4f} (device "
                                  f"{x['device_ms']})"
                                  for t, x in rr["forced"].items())
                      + f"  [{card}]")
                if label == cell and len(rr["forced"]) > 1:
                    # device ms by form
                    sweep.setdefault(cell, {}).setdefault(kname, []).append(
                        {"lanes": rr["lanes"], rr["form"]: rr["device_ms"],
                         **{t: x["device_ms"]
                            for t, x in rr["forced"].items()}})
        print_profile(f"unrolled {label} @{size}{branch}", frame, card, 3)
        del recs[label]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    b = results.get(CASES[0][1], {}).get("pixel_eval_runs", {})
    v = results.get(CASES_3D[0][0], {}).get("voxel_eval_3d", {})
    for label, rr in (("B (interpreter, stress 1024^2)", b),
                      ("V (interpreter, gyroid 1024^3)", v)):
        if rr.get("device_ms"):
            print(f"  beside: {label} {rr['clauses'] / rr['device_ms'] / 1e9:.3f}"
                  " T pixel-clauses/s")
    # ---- against the first design, in this run ------------------------------
    verdicts = {}
    for kname, *_ in UNROLLED_ROWS:
        for label, rr in rows[kname].items():
            new = [x["device_ms"] for x in rr]
            old = [x["forced"]["serial"].get("device_ms") for x in rr]
            if None in new or None in old:
                verdicts[f"{kname} {label}"] = "not measured"
                print(f"  {kname} {label}: a device time against the first "
                      f"design not measured (the profiler traced no such "
                      f"kernel)  [{card}]")
                continue
            ratio = sum(new) / sum(old)
            aim = FIRST_DESIGN_AIM.get(kname, {}).get(
                label.removesuffix(" steady"), 1.1)
            verdicts[f"{kname} {label}"] = round(ratio, 4)
            print(f"  {kname} {label}: device {sum(new):.4f} ms "
                  f"({' + '.join(x['form'] for x in rr)}) against the first "
                  f"design's {sum(old):.4f} ms in this run: x{ratio:.3f}, "
                  f"{'held' if ratio <= aim else 'MISSED'} (at most "
                  f"{aim}); recorded first design: "
                  f"{PREVIOUS_DESIGN_MS.get(kname, {}).get(label)}  [{card}]")
    results["unrolled_sweep"] = sweep
    results["unrolled_vs_first_design"] = verdicts

    # ---- the command line ----------------------------------------------------
    import tempfile
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    n_blobs, size = CASES[0]
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["render2d", f"stress:{n_blobs}", "--size", str(size),
                "--engine", "unrolled", "--check"]
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli", *argv],
                           cwd=tmp, env=env, capture_output=True, text=True,
                           timeout=600)
        print(f"cli {' '.join(argv)}: exit {p.returncode}, "
              f"{time.perf_counter() - t0:.1f} s")
        for line in p.stdout.strip().splitlines():
            print("    " + line)
        check(p.returncode == 0, f"cli render2d --engine unrolled failed:\n"
              f"{p.stderr}")
        check("oracle cross-check: mismatch 0.00e+00" in p.stdout,
              "cli render2d --engine unrolled printed no exact cross-check")
        # table3d on the gyroid cell's model at the table's own sizes
        # (unrolled by default: a full-ladder frame, then steady frames)
        from mpr_tpu_torch.frontend import frep, shapes
        name, make = CASES_3D[0][:2]
        path = os.path.join(tmp, f"{name}.frep")
        frep.dump([frep.ArchiveShape(tree=make(shapes), name=name)], path)
        argv = ["table3d", path]
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli", *argv],
                           cwd=tmp, env=env, capture_output=True, text=True,
                           timeout=600)
        print(f"cli table3d {name}.frep (sizes 256-2048, bench3d_view): "
              f"exit {p.returncode}, {time.perf_counter() - t0:.1f} s  "
              f"[{card}]")
        for line in (p.stdout + p.stderr).strip().splitlines():
            print("    " + line)
        check(p.returncode == 0, f"cli table3d failed:\n{p.stderr}")
        rows3 = [ln_.split() for ln_ in p.stdout.splitlines()[1:]]
        check(rows3 and rows3[0][0] == "256" and all(
            float(ms) > 0 for _, ms in rows3), "cli table3d printed no row")

    # ---- the kernels line's rows -------------------------------------------------
    out = []
    for kname, _, replaces in UNROLLED_ROWS:
        per = {}
        for label, _, _, mat, _, skip4 in frames_of:
            rr = rows[kname].get(label)
            if not rr:
                continue

            def total(key, rr=rr, of=lambda x: x):
                v = [of(x).get(key) for x in rr]
                return None if None in v else round(sum(v), 6)
            per[label] = {
                "branch": None if mat is None
                else "skip4" if skip4 else "full ladder",
                "launches": len(rr),
                "lanes": [x["lanes"] for x in rr],
                "forms": [x["form"] for x in rr],
                "registers": [x["registers"] for x in rr],
                "ms_each": [round(x["ms"], 6) for x in rr],
                "ms": round(sum(x["ms"] for x in rr), 6),
                "wrapper_ms": round(sum(x["wrapper_ms"] for x in rr), 6),
                "device_ms": total("device_ms"),
                "device_ms_each": [x["device_ms"] for x in rr],
                "first_design_device_ms": total(
                    "device_ms", of=lambda x: x["forced"]["serial"]),
                "plain_ms": round(sum(x["plain_ms"] for x in rr), 3),
                "bound_ms": round(sum(x["bound_ms"] for x in rr), 6),
                "bound_by": rr[-1]["bound_by"],
                "issue_floor_ms": total("issue_floor_ms"),
                "sass_per_lane": [x.get("sass_per_lane") for x in rr],
                "T_lane_clauses_per_s": [round(x["rate"], 4) for x in rr],
                "frame_ms": round(frame_ms[label], 4),
                "frame_ms_first_design": round(
                    frame_ms[f"{label} first design"], 4)}
        at = max(per, key=lambda c: per[c]["ms"])
        p = per[at]
        out.append({
            "name": kname, "route": "cuda", "source": UNROLLED_SOURCE,
            "replaces": replaces, "port_kernel": True,
            "launches": launches["unrolled"][kname],
            "max_abs_err": max(x["max_abs_err"] for c in rows[kname].values()
                               for x in c),
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
            "library_ms": None, "at": at,
            "issue_floor_ms": p["issue_floor_ms"], "per_cell": per,
            "build_s": {f"{x['cell']} {x['form']}": x["seconds"]
                        for x in facts.values()
                        if "unrolled_" + x["kind"] == kname}})
    results["unrolled"] = out


# ---------------------------------------------------------------------------
# Phase 17: the unrolled 3D ladder's options
# ---------------------------------------------------------------------------

# the voxel stages phase 17 runs at each 3D cell, and the debug_stage stops
# it times of each (the stops before the voxel stage's choice, "A" and "B",
# once)
OPTIONS = ("single", "two_phase", "refine2")
OPTION_STOPS = {"single": ("A", "B", "Bp", "V"), "two_phase": ("Bp", "V"),
                "refine2": ("Bp", "R", "V")}
OPTION_REPS = 10
STOP_REPS = 5
# the launches of a shape no other phase holds, by option: kernel -> the
# launches of the frame before them (the children's interval launches
# after the ladder's three; every float launch: k = 2, and both phases')
NEW_SHAPES = {"two_phase": {"unrolled_float": 0},
              "refine2": {"unrolled_interval": 3, "unrolled_float": 0}}


def option_frame(unrolled, r, mat_t, size, option, stop=""):
    """``frame() -> (depth, normals, counts)`` of the full ladder (skip4
    off) with the voxel stage of ``option``: the renderer's ``frame3d``
    (with its ``two_phase``), or ``_render3d_impl(refine2=True)``, the
    only way to the 2^3 sub-refinement; with ``stop``, the ladder up to
    that ``debug_stage``."""
    if option != "refine2" and not stop:
        return lambda: r.frame3d(mat_t, size, skip4=False,
                                 two_phase=option == "two_phase")
    imms = r._imms_arg(None, mat_t.device)
    return lambda: unrolled._render3d_impl(
        r.fi, r.f, r.fd, mat_t, size, True, False, imms,
        two_phase=option == "two_phase", refine2=option == "refine2",
        debug_stage=stop)


def option_launches(unrolled, option, cnt):
    """The launches of each generated kernel a frame of ``option`` with
    the counts ``cnt`` must make."""
    if option == "two_phase":
        floats = (unrolled.voxel_launches(cnt[3], 4)
                  + unrolled.voxel_launches(cnt[4], 4))
    elif option == "refine2":
        floats = unrolled.voxel_launches(cnt[3], 2)
    else:
        floats = unrolled.voxel_launches(cnt[2], 4)
    # the children's interval launches: one a chunk of VOXEL_LANES / 8
    # cells, as the float launches of 2^3 voxels
    children = unrolled.voxel_launches(cnt[2], 2)
    return {"unrolled_interval": 3 + (children if option == "refine2"
                                      else 0),
            "unrolled_float": floats, "unrolled_deriv": 1}


def run_options(ctx, results, launches):
    """Phase 17: the two-phase voxel stage, the 2^3 sub-refinement and the
    stops of the unrolled 3D ladder at each 3D cell (after phase 13, which
    built the cells' generated kernels)."""
    import torch
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import unrolled
    card, dev = ctx["card"], ctx["dev"]
    recorder = Recorder({"unrolled_eval": ue}, UNROLLED_ROWS)
    plain_calls = [0]
    real_plain = ue.UnrolledEval.plain

    def counted_plain(self, *a, **k):
        plain_calls[0] += 1
        return real_plain(self, *a, **k)
    out, per_frame = {}, {}
    for cell, tape, mat, size in unrolled_cells()[1:]:
        r = unrolled.get_renderer(tape)
        mat_t = torch.as_tensor(mat, device=dev)
        res = out[cell] = {}
        frames = {}
        for option in OPTIONS:
            frame = option_frame(unrolled, r, mat_t, size, option)
            log = {}
            if option != "single":
                recorder.install(log)
            recorder.reset_counts()
            plain_calls[0] = 0
            ue.UnrolledEval.plain = counted_plain
            try:
                depth, normals, cnt = frame()
                torch.cuda.synchronize()
            finally:
                ue.UnrolledEval.plain = real_plain
                recorder.remove()
            got = per_frame[f"{cell} {option}"] = recorder.counts()
            need = option_launches(unrolled, option, cnt)
            frames[option] = (depth.cpu().numpy(), normals.cpu().numpy())
            del depth, normals
            print(f"unrolled option {option} {cell} @{size}: counts {cnt}, "
                  f"launches {got}, expected {need}; {plain_calls[0]} plain "
                  "evaluator calls")
            check(got == need, f"the unrolled {option} frame of {cell} "
                  f"launched {got}, {need} expected")
            check(plain_calls[0] == 0, f"the unrolled {option} frame of "
                  f"{cell} ran a plain evaluator {plain_calls[0]} times")
            # the launches of a new shape against their plain versions:
            # the children's interval launches and the k = 2 float
            # launches of refine2, both phases' float launches
            held, err = [], 0.0
            for kname, skip in NEW_SHAPES.get(option, {}).items():
                for j, (a, k, o) in enumerate(log.get(kname, [])[skip:]):
                    pout = a[0].plain(*a[1:], imms=k.get("imms"))
                    outs = o if isinstance(o, tuple) else (o,)
                    pouts = pout if isinstance(pout, tuple) else (pout,)
                    bad = bits_differ(outs, pouts)
                    err = max([err] + [same(x, y)[1]
                                       for x, y in zip(outs, pouts)])
                    held.append(f"{kname} {outs[0].numel()} lanes: {bad}")
                    check(bad == 0, f"{kname} launch {j + skip} of the "
                          f"{option} frame of {cell} differs from its plain "
                          f"version in {bad} values")
                    del pout, pouts
            del log
            if held:
                print(f"  new-shape launches against their plain versions "
                      f"(values whose bits differ): {held}; max |err| "
                      f"{err:.3g}")
            single_d, single_n = frames["single"]
            d, nrm = frames[option]
            off = {"single phase": int((d != single_d).sum()),
                   "render3d_brute": int((d != ctx["brute3d"][cell]).sum())}
            nbad = int((nrm != single_n).sum())
            print(f"  {option} depth vs {off} pixels differ; normals: "
                  f"{nbad} values differ from the single phase's")
            check(not any(off.values()) and nbad == 0, f"the {option} frame "
                  f"of {cell} differs: depth {off}, normals {nbad}")
            res[option] = {"counts": list(cnt), "launches": got}
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        n2 = res["single"]["counts"][2]
        na, nb = res["two_phase"]["counts"][3:5]
        m3 = res["refine2"]["counts"][3]
        res["culled_by_phase_2"] = n2 - na - nb
        res["ambiguous_children_share"] = m3 / max(8 * n2, 1)
        print(f"unrolled options {cell} @{size}: n2 {n2} cells; two-phase: "
              f"na {na}, nb {nb}, phase 2 culled {n2 - na - nb}; refine2: "
              f"m3 {m3} ambiguous children of {8 * n2} "
              f"({100 * m3 / max(8 * n2, 1):.2f}%)")
        # ---- times: the frames, their profiles and their stops --------------
        for option in OPTIONS:
            frame = option_frame(unrolled, r, mat_t, size, option)
            ms = cuda_ms(frame, OPTION_REPS, 2)
            wall, rows, busy = profile_frames(frame, 3)
            gen = sum(v for k, v in rows if GENERATED_KERNEL in k)
            rest = sum(v for k, v in rows if GENERATED_KERNEL not in k)
            stops = {}
            for stop in OPTION_STOPS[option]:
                stops[stop] = round(cuda_ms(option_frame(
                    unrolled, r, mat_t, size, option, stop), STOP_REPS, 1), 4)
            res[option].update(
                frame_ms=round(ms, 4), host_ms_profiled=round(wall, 4),
                generated_device_ms=round(gen, 4) if rows else None,
                other_device_ms=round(rest, 4) if rows else None,
                busy=round(busy, 4) if rows else None, stop_ms=stops)
            print(f"unrolled option {option} {cell} @{size}: frame {ms:.3f} "
                  f"ms (events, median of {OPTION_REPS}); generated kernels "
                  + (f"{gen:.4f} ms, other device work {rest:.4f} ms, busy "
                     f"{100 * busy:.1f}% (torch.profiler, 3 frames)" if rows
                     else "not measured (no device time in the trace)")
                  + f"; frame ms at each stop (median of {STOP_REPS}) "
                  f"{stops}  [{card}]")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    launches["unrolled_options"] = per_frame
    for row in results["unrolled"]:
        row["launches_options"] = {k: v[row["name"]]
                                   for k, v in per_frame.items()}
    results["unrolled_options"] = out


# ---------------------------------------------------------------------------
# Phase 14: mesh export and differentiable fitting
# ---------------------------------------------------------------------------

# The port's own backward kernels (no TPU kernel behind them: on the TPU
# the gradient is XLA's transpose under jax.value_and_grad): wrapper,
# module, name, source, what the JAX package does instead.
FIT_ROWS = (
    ("unrolled_float_vjp", "unrolled_eval", "K1",
     "mpr_tpu_torch/ops/unrolled_eval.py (generated per tape: "
     "generate_vjp_fwd, generate_vjp) + mpr_tpu_torch/ops/csrc/unrolled.cuh"
     " + adjoint.cuh",
     "mpr_tpu/parallel/sharded.py:239-584 (jax.value_and_grad of the "
     "unrolled float chain; XLA, no TPU kernel)"),
    ("scan_adjoint", "eval_scan", "K2",
     "mpr_tpu_torch/ops/csrc/scan_adjoint.cu + adjoint.cuh",
     "mpr_tpu/parallel/sharded.py:192-236 (jax.value_and_grad of "
     "eval_scan.eval_f; XLA, no TPU kernel)"),
    ("scan_eval", "eval_scan", "K2f",
     "mpr_tpu_torch/ops/csrc/scan_eval.cu + mpr_tpu_torch/ops/scan_plan.py",
     "mpr_tpu/ops/eval_scan.py:78 (eval_f, a lax.scan; XLA, no TPU "
     "kernel)"),
)
FIT_STEPS = 4
# phase 14's sizes: the mesh grid, the 2D fits (the culled one also at the
# 2D cell's size), the dense 3D grid, the 3D window fit; the process
# group's backend; arguments every command-line run gets
MESH_N = 128
FIT_2D, FIT_2D_BIG, FIT_GRID, FIT_WINDOW = 256, 1024, 32, 512
FIT_BACKEND = "nccl"
CLI_EXTRA = []
# gradient of a step's kernels against its plain versions on the same
# inputs: the largest difference over the largest component.  Float32 sums
# over up to 2.1 M lanes in another order (warp shuffles, shared atomics,
# blocks, chunks) against autograd's; measured 4e-7 at 65,536 lanes on the
# H100.
FIT_GRAD_TOL = 1e-4
# lanes a plain VJP takes at once (autograd keeps every clause's output)
PLAIN_CHUNK = 1 << 16
# Forced launch shapes of K2 timed at the scan fit (adjoint_launch's
# keyword arguments)
EDGE_K2 = ([dict(home="shared", k=kk) for kk in (2, 4)]
           + [dict(home="local", k=kk, threads=t) for kk, t in
              ((2, 64), (2, 128), (2, 256), (4, 64), (4, 128))])


def vjp_ops(tape):
    """Float operations a lane of d(sum g f)/d(imms) needs, whatever
    computes it: the forward walk's (FLOAT_OPS, every clause) and each
    reverse step's (``vjp_plan.vjp_ops``: the rule's operations and one
    addition a share handed on, every clause whose output reaches the
    result)."""
    from mpr_tpu_torch.ops import vjp_plan as vp
    plan = vp.plan_of_tape(tape)
    ops = [int(o) for o in tape.ops]
    return (sum(FLOAT_OPS.get(o, 0) for o in ops)
            + sum(vp.vjp_ops(o) for o, h in zip(ops, plan.has) if h))


def fit_cells():
    """Phase 14's tapes: (name, tape) of stress_2d(600), the gyroid model
    and the extruded model (the chip cells' tapes)."""
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    n_blobs, _ = CASES[0]
    out = [(f"stress_2d({n_blobs})",
            mpr_tpu_torch.compile_tree(shapes.stress_2d(n_blobs)))]
    for name, make, _, _ in CASES_3D:
        out.append((name, mpr_tpu_torch.compile_tree(make(shapes))))
    return out


def start_fit_builds():
    """Start building phase 14's generated kernels (the imm-input float
    and interval evaluators and both halves of K1 for the three tapes) in
    a thread, beside phase 1's and phase 13's."""
    import threading
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import unrolled
    cells = fit_cells()
    evals = []
    for _, tape in cells:
        r = unrolled.get_renderer(tape, imm_inputs=True)
        evals += [r.fi, r.f] + r.f.vjp.evals
    box = {"cells": cells, "evals": evals}

    def work():
        t0 = time.perf_counter()
        try:
            ue.build_all(evals)
        except BaseException as e:       # re-raised by phase 14
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0
    box["thread"] = threading.Thread(target=work, daemon=True)
    box["thread"].start()
    return box


class Counts:
    """The launch counters phase 14 reads, and the plain evaluators' calls
    (which no fit step on the card may make)."""

    def __init__(self):
        from mpr_tpu_torch.ops import eval_scan
        from mpr_tpu_torch.ops import unrolled_eval as ue
        self.fns = {"unrolled_float": ue._unrolled_float,
                    "unrolled_interval": ue._unrolled_interval,
                    "unrolled_deriv": ue._unrolled_deriv,
                    "unrolled_float_vjp": ue._unrolled_float_vjp,
                    "scan_adjoint": eval_scan._scan_adjoint,
                    "scan_eval": eval_scan._scan_eval}
        self.plain = [0]
        self.mods = (ue, eval_scan)
        self.saved = (ue.UnrolledEval.plain, eval_scan._walk_f)
        real_plain, real_walk = self.saved

        def plain(ev, *a, **k):
            self.plain[0] += 1
            return real_plain(ev, *a, **k)

        def walk(*a, **k):
            self.plain[0] += 1
            return real_walk(*a, **k)
        self.hooks = (plain, walk)

    def __enter__(self):
        for fn in self.fns.values():
            fn.launches = 0
        self.plain[0] = 0
        self.mods[0].UnrolledEval.plain, self.mods[1]._walk_f = self.hooks
        return self

    def __exit__(self, *exc):
        self.mods[0].UnrolledEval.plain, self.mods[1]._walk_f = self.saved
        self.read = {k: fn.launches for k, fn in self.fns.items()}
        self.read["plain"] = self.plain[0]


def plain_vjp_unrolled(ue, ev, x, y, z, g, imms):
    """K1's plain version on the card, in chunks of lanes: autograd
    through the plain walk (``UnrolledEval.plain``)."""
    import torch
    lanes = [t.reshape(-1) for t in torch.broadcast_tensors(x, y, z, g)]
    T = ev.tape.length
    out = torch.zeros(T, dtype=torch.float32, device=lanes[0].device)
    for c0 in range(0, lanes[0].numel(), PLAIN_CHUNK):
        xs, ys, zs, gs = (t[c0:c0 + PLAIN_CHUNK] for t in lanes)
        im = imms.detach()[:T].clone().requires_grad_(True)
        with torch.enable_grad():
            v = ev.plain(xs, ys, zs, imms=im)
            d, = torch.autograd.grad(v, im, gs, allow_unused=True)
        if d is not None:
            out += d
    return out


def plain_vjp_scan(eval_scan, td, x, y, z, g):
    """K2's plain version on the card, in chunks of lanes: autograd
    through the plain interpreter walk."""
    import torch
    out = torch.zeros_like(td.imms)
    for c0 in range(0, x.numel(), PLAIN_CHUNK):
        sl = slice(c0, c0 + PLAIN_CHUNK)
        im = td.imms.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            v = eval_scan.eval_f_plain(td.replace_imms(im), x[sl], y[sl],
                                       z[sl])
            d, = torch.autograd.grad(v, im, g[sl], allow_unused=True)
        if d is not None:
            out += d
    return out


def half_ms(kname, a, ue, eval_scan):
    """The forward half of K1 (its bare launch) or K2's K2f storing the
    plan, alone, on a recorded call's inputs: {"forward_ms": events}."""
    import torch
    from mpr_tpu_torch.ops import vjp_plan as vp
    if kname == "unrolled_float_vjp":
        ev, x, y, z, g, imms = a
        lanes = [t.reshape(-1).contiguous()
                 for t in torch.broadcast_tensors(x, y, z)]
        n, plan = lanes[0].numel(), ev.plan
        if ue.vjp_chunk(plan, n) < n:
            return {}
        vals, ch = vp.workspace("K1", lanes[0].device, [
            (vp.blocked_size(plan.n_vals, n), torch.float32),
            (vp.blocked_size(plan.n_words, n), torch.int32)])
        im = torch.as_tensor(imms, dtype=torch.float32,
                             device=lanes[0].device).contiguous()
        return {"forward_ms": cuda_ms(lambda: ue._launch(
            ev.fwd, lanes, im, [vals, ch]), 5, 1)}
    if kname == "scan_adjoint":
        td, x, y, z, g = a
        plan, n = td.vjp_plan()[0], x.numel()
        vals, words = vp.workspace("K2", td.device, [
            (vp.blocked_size(plan.n_vals, n), torch.float32),
            (vp.blocked_size(plan.n_words, n), torch.int32)])
        return {"forward_ms": cuda_ms(lambda: eval_scan.scan_eval(
            td, x, y, z, store=(vals, words)), 5, 1)}
    return {}


def sweep_k2(eval_scan, ln, td, x, y, z, g, want, card):
    """K2 (with its K2f) at each shape of ``EDGE_K2`` on a fit's recorded
    inputs: each held to ``want`` (the plain gradient) within
    FIT_GRAD_TOL, timed; a shape that does not fit is printed as
    refused.  Returns {label: ms}."""
    out = {}
    s_cap = eval_scan.adjoint_s_cap(td)
    scale = float(want.abs().max())
    for kw in EDGE_K2:
        try:
            shape = ln.adjoint_launch(s_cap, td.length, **kw)
        except ValueError:
            print(f"    K2 shape {kw}: refused (does not fit)")
            continue
        label = f"{shape.home} {shape.threads}x{shape.k}"
        got = eval_scan.scan_adjoint(td, x, y, z, g, launch=shape)
        err = float((got - want).abs().max())
        check(err <= FIT_GRAD_TOL * scale, f"K2 at {label} differs from "
              f"its plain version by {err} (largest {scale})")
        out[label] = cuda_ms(lambda: eval_scan.scan_adjoint(
            td, x, y, z, g, launch=shape), 5, 1)
        print(f"    K2 shape {label} (smem {shape.smem} B): "
              f"{out[label]:.4f} ms with its K2f, max |err| {err:.3e} of "
              f"{scale:.3e}  [{card}]")
    return out


def k2f_ptxas():
    """ptxas's (registers, stack, spill stores, spill loads) of K2f's walk
    by (K, storing) and of its first design by ("first", storing), from
    the libraries' nvcc logs."""
    from mpr_tpu_torch.ops import build
    out = {}
    for log in build.BuildStats.log.values():
        for kern, k, b, regs, stack, st, ld in ptxas_rows(log):
            if kern == "scan_walk_kernel":
                out[(k, bool(b))] = (regs, stack, st, ld)
            elif kern == "scan_eval_first_kernel":
                out[("first", bool(k))] = (regs, stack, st, ld)
    return out


def k2f_store(td, n):
    """Zeroed tensors for K2f's store of ``n`` lanes (the plan's values
    and choice words in the blocked layout).  Neither design writes a lane
    past ``n``, so two stores made alike compare whole."""
    import torch
    from mpr_tpu_torch.ops import vjp_plan as vp
    plan = td.vjp_plan()[0]
    return (torch.zeros(vp.blocked_size(plan.n_vals, n), dtype=torch.float32,
                        device=td.device),
            torch.zeros(vp.blocked_size(plan.n_words, n), dtype=torch.int32,
                        device=td.device))


def same_bits(a, b):
    """Equal bit for bit (every NaN alike), float or integer."""
    import torch
    if a.dtype == torch.float32:
        a, b = (torch.nan_to_num(t, 7.0).view(torch.int32) for t in (a, b))
    return a.shape == b.shape and bool(torch.equal(a, b))


def k2f_ms(fn, name):
    """Device ms of the K2f kernel ``fn()`` launches (its name holds
    ``name``): torch.profiler, or where three traces hold no record of
    it, CUDA events around the call (median of 5; they add the host's
    enqueue of the call's small kernels, under 0.05 ms)."""
    ms = device_ms(fn, 3, name, 3)
    return ms if ms is not None else round(cuda_ms(fn, 5, 1), 6)


def k2f_launch(label, td, x, y, z, store, card):
    """K2f at one launch of a path, on its recorded lanes: the picked
    shape and every shape of ``SCAN_SWEEP``, the first design and the
    plain version (the tape-order walk, and with ``store`` its store,
    ``scan_plan.store_plain``) on the same inputs.  Every shape's v, and
    with ``store`` its values and choice words, must equal the first
    design's bit for bit (the stores' whole bytes) and the plain
    version's; each is timed (device ms, torch.profiler) beside the first
    design's and the bound (inputs, v, the walk's entries and the store's
    bytes; the walk's float operations).  Returns the launch's row."""
    import numpy as np
    import torch
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops import scan_plan as spm
    sp = td.scan_plan()[0]
    plan = td.vjp_plan()[0]
    n = x.numel()
    pick = ln.scan_launch(sp.slots, n)
    first_st = k2f_store(td, n) if store else None
    v1 = eval_scan.scan_eval_first(td, x, y, z, store=first_st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if store:
        pv, pvals, pwords = spm.store_plain(td, x, y, z)
    else:
        pv = eval_scan.eval_f_plain(td, x, y, z)
    torch.cuda.synchronize()
    plain_ms_ = (time.perf_counter() - t0) * 1e3
    check(same_bits(v1, pv), f"K2f's first design differs from the plain "
          f"walk at {label}")
    if store:
        check(same_bits(first_st[0][:pvals.numel()], pvals)
              and same_bits(first_st[1][:pwords.numel()], pwords),
              f"K2f's first design stores other bits than the plain walk "
              f"at {label}")
    regs = k2f_ptxas()
    sweep = {}
    for shape in (pick,) + tuple(s for s in ln.SCAN_SWEEP if s != pick):
        st = k2f_store(td, n) if store else None
        v = eval_scan.scan_eval(td, x, y, z, store=st, launch=shape)
        ok = same_bits(v, v1) and (not store or (
            same_bits(st[0], first_st[0]) and same_bits(st[1], first_st[1])))
        check(ok, f"K2f at {shape} differs from its first design at {label}"
              f" (v, or the store's bytes)")
        tag = f"{shape.threads}x{shape.k}"
        sweep[tag] = k2f_ms(lambda: eval_scan.scan_eval(
            td, x, y, z, store=st, launch=shape), "scan_walk_kernel")
        del v, st
    first_ms = k2f_ms(lambda: eval_scan.scan_eval_first(
        td, x, y, z, store=first_st), "scan_eval_first_kernel")
    tag = f"{pick.threads}x{pick.k}"
    P = sp.length
    ops = n * sum(FLOAT_OPS.get(int(plan.ops[t]), 0) for t in sp.order)
    nbytes = n * 16 + P * 16 + (n * plan.k2_lane_bytes if store else 0)
    # the design's own floor: its file's shared-memory traffic (each
    # operand read from the file, each value kept, each choice word's
    # read-modify-write between its first and last code) at 128 bytes a
    # clock an SM, or the bound's bytes, whichever is longer
    fl = sp.fl.astype(np.int64) & 0xFFFFFFFF
    cw = (sp.st.astype(np.int64) & 0xFFFFFFFF) >> 16 != spm.NONE16
    access = (np.sum((fl & spm.A_ACC) == 0) + np.sum((fl & spm.B_ACC) == 0)
              + np.sum((fl & spm.KEEP) != 0))
    if store:
        access += (np.sum(cw & ((fl & spm.W_FIRST) == 0))
                   + np.sum(cw & ((fl & spm.W_LAST) == 0)))
    file_bytes = n * 4 * int(access)
    shared_ms = file_bytes / (132 * 128 * sm_clock_hz()) * 1e3
    row = dict(lanes=n, clauses=P, store=bool(store), ops=ops, bytes=nbytes,
               file_slots=sp.slots, tape_slots=td.num_slots,
               shape=dict(threads=pick.threads, k=pick.k,
                          smem=pick.smem(sp.slots),
                          blocks=ln.scan_blocks(pick, sp.slots, n)),
               ptxas=regs.get((pick.k, bool(store))),
               first_ptxas=regs.get(("first", bool(store))),
               device_ms=sweep[tag], first_device_ms=first_ms,
               plain_ms=plain_ms_, sweep=sweep, max_abs_err=0.0)
    row["bound_ms"], row["bound_by"] = bound(row)
    row["file_bytes"] = file_bytes
    row["floor_ms"] = max(shared_ms, nbytes / PEAK_BYTES_PER_S * 1e3)
    ratio = (row["device_ms"] / first_ms if row["device_ms"] and first_ms
             else None)
    row["vs_first"] = ratio
    print(f"  K2f at {label}: {n} lanes x {P} clauses"
          f"{' storing the plan' if store else ''}, shape {tag} "
          f"(smem {row['shape']['smem']} B, {row['shape']['blocks']} "
          f"blocks), file {sp.slots} slots against the tape's "
          f"{td.num_slots}; device {row['device_ms']} ms, the first design "
          f"{first_ms} ms (x{ratio if ratio is None else round(ratio, 4)})"
          f"; bound {row['bound_ms']:.5f} ms ({row['bound_by']}), the "
          f"design's floor {row['floor_ms']:.5f} ms ({file_bytes} B of "
          f"file traffic); plain "
          f"{plain_ms_:.1f} ms; ptxas (registers, stack, spill stores, "
          f"loads) {row['ptxas']}, first design {row['first_ptxas']}; "
          f"every shape bit-equal to the first design and the plain "
          f"version; sweep {sweep}  [{card}]")
    return row


def run_k2f(ctx, results):
    """Phase 15: K2f at the dense references.  With K2f's count set to 0,
    ``render2d_brute`` of each 2D cell and ``render3d_brute`` of each 3D
    cell (one launch a frame in 2D, one a slab of rows in 3D; the images
    equal phases 3's and 7's); then, on the recorded lanes of the 2D
    launches and of one slab a 3D cell (the middle one), K2f against its
    plain version and its first design at every swept shape, timed
    (:func:`k2f_launch`)."""
    import mpr_tpu_torch
    import numpy as np
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.ops import eval_scan
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.render import brute, camera
    card, dev = ctx["card"], ctx["dev"]
    real = eval_scan.scan_eval
    rows, counts = {}, {}
    jobs = [(f"brute 2D stress_2d({nb}) {sz}^2",
             lambda nb=nb, sz=sz: brute.render2d_brute(
                 mpr_tpu_torch.compile_tree(shapes.stress_2d(nb)), size=sz),
             ctx["brute2d"][sz], 0) for nb, sz in CASES]
    for name, make, view, size in CASES_3D:
        slabs = -(-size // max(1, brute.SLAB_VOXELS // (size * size)))
        jobs.append((f"brute 3D {name} {size}^3 (slab {slabs // 2} of "
                     f"{slabs})", lambda make=make, view=view, size=size:
                     brute.render3d_brute(
                         mpr_tpu_torch.compile_tree(make(shapes)),
                         mat=camera.gui3d_view(*view), size=size),
                     ctx["brute3d"][name], slabs // 2))
    for label, render, want, keep in jobs:
        seen = []

        def rec(td, x, y, z, store=None, launch=None):
            if len(seen) == keep:
                seen.append((td, x, y, z))
            else:
                seen.append(None)
            return real(td, x, y, z, store=store, launch=launch)
        eval_scan._scan_eval.launches = 0
        eval_scan.scan_eval = rec
        try:
            img = render()
        finally:
            eval_scan.scan_eval = real
        counts[label] = eval_scan._scan_eval.launches
        bad = int(np.sum(img != want))
        print(f"K2f phase: {label}: {counts[label]} K2f launches, "
              f"{bad} pixels differ from the phase's earlier image")
        check(counts[label] == len(seen) >= keep + 1,
              f"{label}: K2f launched {counts[label]} times")
        check(bad == 0, f"{label}: the image differs")
        td, x, y, z = seen[keep]
        rows[label] = k2f_launch(label, td, x, y, z, False, card)
        rows[label]["launches"] = counts[label]
        del seen
    results["k2f"] = rows


# ---- phase 16: the native tape compiler and the viewer ----------------------

# compiles a tape is timed over (after one warm-up), as ``cli tape-time``
COMPILE_REPS = 100
# the big tapes whose native compile phase 16 also times flatten_tree of
# (the tree's Python half of it)
NATIVE_SPLIT = ("stress_2d(600)", "stress_2d(1500)", "gyroid_sphere",
                "extruded_stress")
# viewer frames timed after warm-up: the median of VIEWER_REPS
VIEWER_REPS = 10
VIEWER_MODES = ("heightmap", "normals", "ssao", "shaded")
VIEWER_SIZE = 512                # the viewer's default size
# seconds phase 16 waits for a frame the HTTP loop asked for: room for a
# cold build of an unrolled tape's kernels
VIEWER_WAIT_S = 180.0
# the script the HTTP loop posts: a tape no earlier phase built, on the
# unrolled engine, so that its kernels build in the render thread
VIEWER_EDIT = "shape = stress_2d(20)\n"
SLIDER_MOVES = ({"radius": 0.8}, {"bore-r": 0.15, "tilt": 1.0},
                {"radius": 0.5, "tilt": 0.2})
HAND_KERNELS = ("interval_shorten_kernel", "compact_kernel",
                "pixel_eval_kernel", "voxel_eval_kernel", "deriv_eval_kernel")
GENERATED_KERNEL = "mpr_unrolled_kernel"
LAUNCHES_3D_KERNELS = ("interval_shorten_kernel", "compact_kernel",
                       "voxel_eval_kernel", "deriv_eval_kernel")
# the marker kernels' lengths (torch.cuda._sleep cycles: about 0.5 ms and
# 0.05 ms at the card's clock) and the length between them
MARKER_CYCLES = (1_000_000, 100_000)
MARKER_SPLIT_US = 200.0


def host_cpu() -> str:
    """The host CPU's model name, as /proc/cpuinfo gives it (else as
    ``lscpu`` does), with the count of CPUs this process may use."""
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip()
                         for ln in out.splitlines()
                         if ln.lower().startswith("model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{name or 'unknown'}, {len(os.sched_getaffinity(0))} CPUs"


def mean_ms(fn, reps):
    """Mean host ms of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def same_tape(a, b) -> bool:
    """Two tapes equal in every field, the immediates bit for bit."""
    import numpy as np
    for f in ("ops", "outs", "lhss", "rhss", "imms"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(
                x.view(np.int32), y.view(np.int32)):
            return False
    return (tuple(a.axis_slots) == tuple(b.axis_slots)
            and (a.result_slot, a.num_slots, a.num_choices)
            == (b.result_slot, b.num_slots, b.num_choices))


def example_trees():
    """(label, tree) of every shape of ``examples/*.py`` and ``*.io``, as
    the viewer evaluates the scripts."""
    import glob
    from mpr_tpu_torch import viewer
    out = []
    paths = sorted(glob.glob(os.path.join(ROOT, "examples", "*.py"))
                   + glob.glob(os.path.join(ROOT, "examples", "*.io")))
    for p in paths:
        with open(p) as f:
            shapes_, _ = viewer._eval_src(f.read(), p)
        name = os.path.basename(p)
        for i, s in enumerate(shapes_):
            out.append((f"{name}[{i}]" if len(shapes_) > 1 else name, s))
    return out


def run_native(ctx, results):
    """Phase 16 (a): the native tape compiler against the Python passes."""
    from mpr_tpu_torch import native
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.frontend.tree import lower_extended
    from mpr_tpu_torch.render import render2d
    from mpr_tpu_torch.tape.fuse import fuse_tree
    from mpr_tpu_torch.tape.tape import compile_tree
    card, cpu = ctx["card"], host_cpu()
    check(native.lib() is not None, "the native tape compiler did not build "
          "or load (g++ -O2 -std=c++17 -shared -fPIC)")
    built = (f"built by g++ in {native.BUILD_SECONDS:.2f} s at its first "
             f"use" if native.BUILD_SECONDS is not None
             else "loaded (built before this run)")
    print(f"native tape compiler: {native.library_path()} {built}")
    trees = [(f"stress_2d({n})", shapes.stress_2d(n)) for n in (600, 1500)]
    trees += [(name, make(shapes)) for name, make, _, _ in CASES_3D]
    trees += example_trees()
    rows, tapes = {}, {}
    for label, tree in trees:
        if tree._param:
            # the native compiler has no PARAM clause: such a tree takes
            # the Python passes under 'auto' and 'native' refuses it
            t = compile_tree(tree)
            check(bool(t.params) and same_tape(
                t, compile_tree(tree, backend="python")),
                f"{label}: 'auto' did not give the Python tape with params")
            try:
                compile_tree(tree, backend="native")
            except RuntimeError:
                pass
            else:
                check(False, f"{label}: backend='native' took a param tree")
            rows[label] = {"clauses": t.length, "params": sorted(t.params)}
            print(f"  {label}: param tree, {t.length} clauses: Python "
                  f"passes ('native' refuses it)")
            continue
        for schedule in ("opruns", "dfs"):
            tn = compile_tree(tree, schedule=schedule, backend="native")
            tp = compile_tree(tree, schedule=schedule, backend="python")
            check(same_tape(tn, tp), f"{label} ({schedule}): the native "
                  f"tape differs from the Python passes'")
            check(same_tape(tn, compile_tree(tree, schedule=schedule)),
                  f"{label} ({schedule}): 'auto' gave another tape")
        tapes[label] = tn = compile_tree(tree)
        r = {"clauses": tn.length,
             "native_ms": mean_ms(lambda: compile_tree(tree,
                                                       backend="native"),
                                  COMPILE_REPS),
             "python_ms": mean_ms(lambda: compile_tree(tree,
                                                       backend="python"),
                                  COMPILE_REPS)}
        if label in NATIVE_SPLIT:
            pre = fuse_tree(lower_extended(tree))
            r["flatten_ms"] = mean_ms(lambda: native.flatten_tree(pre),
                                      COMPILE_REPS)
        rows[label] = r
        split = (f" (of which flatten_tree {r['flatten_ms']:.3f} ms)"
                 if "flatten_ms" in r else "")
        print(f"  {label}: {tn.length} clauses, native {r['native_ms']:.3f} "
              f"ms, Python passes {r['python_ms']:.3f} ms "
              f"({r['python_ms'] / r['native_ms']:.2f}x){split}, mean of "
              f"{COMPILE_REPS}")
    print(f"native tape compiler: {len(rows)} tapes bit-equal to the Python "
          f"passes in both schedules; host CPU {cpu}  [{card}]")
    # the phase-2 frame from the native tape and from the Python one
    n_blobs, size = CASES[0]
    want = ctx["images2d"][size]
    for backend in ("native", "python"):
        img = render2d(compile_tree(shapes.stress_2d(n_blobs),
                                    backend=backend), size=size)
        bad = int((img != want).sum())
        check(bad == 0, f"stress_2d({n_blobs}) {size}^2 from the {backend} "
              f"tape: {bad} pixels differ from phase 2's image")
    print(f"stress_2d({n_blobs}) {size}^2 from the native and the Python "
          f"tape: equal to phase 2's image")
    results["native"] = {"host_cpu": cpu, "reps": COMPILE_REPS,
                         "build_s": native.BUILD_SECONDS, "tapes": rows}


def composed(shapes_, cam, mode, size, engine):
    """The image the viewer should send for ``shapes_``, made from the
    engines' public renders (each a copy to the host) and the effects on
    the card."""
    import numpy as np
    import torch
    import mpr_tpu_torch
    from mpr_tpu_torch import viewer
    from mpr_tpu_torch.render import effects, pipeline2d, pipeline3d
    from mpr_tpu_torch.render import unrolled
    r2 = unrolled.render2d if engine == "unrolled" else pipeline2d.render2d
    r3 = unrolled.render3d if engine == "unrolled" else pipeline3d.render3d
    mat = viewer.view_matrix(cam, mode)
    if mode == "2d":
        acc = np.zeros((size, size), bool)
        for s in shapes_:
            acc |= r2(mpr_tpu_torch.compile_tree(s), mat=mat, size=size)
        return np.where(acc[::-1], 255, 0).astype(np.uint8)
    depth = np.zeros((size, size), np.int32)
    normals = np.zeros((size, size, 3), np.float32)
    for s in shapes_:
        d, n = r3(mpr_tpu_torch.compile_tree(s), mat=mat, size=size)
        win = d > depth
        depth = np.where(win, d, depth)
        normals = np.where(win[..., None], n, normals)
    if mode == "heightmap":
        return (depth / size * 255).astype(np.uint8)[::-1]
    if mode == "normals":
        return ((normals * 127) + 128).clip(0, 255).astype(np.uint8)[::-1]
    fn = effects.draw_ssao if mode == "ssao" else effects.draw_shaded
    img = fn(torch.as_tensor(depth).cuda(), torch.as_tensor(normals).cuda())
    return (img * 255).to(torch.uint8).cpu().numpy()[::-1]


def generated_counts():
    from mpr_tpu_torch.ops import unrolled_eval as ue
    return {"unrolled_" + k: getattr(ue, "unrolled_" + k).launches
            for k in ("interval", "float", "deriv")}


def reset_generated():
    from mpr_tpu_torch.ops import unrolled_eval as ue
    for k in ("interval", "float", "deriv"):
        getattr(ue, "unrolled_" + k).launches = 0


def frame_times(src, cam, mode, size, engine, path, compile_fn=None):
    """Median over VIEWER_REPS viewer frames after two warm-up ones (host
    clock): the frame (``render_scene``'s own ms), its parts — the host's
    ``compile_tree``, a 3D frame's ``compose`` (the effects and the 8-bit
    image, between two synchronisations), the rest (the shapes' renders,
    compositing, the copy to the host) — and the frame with the script's
    evaluation."""
    import statistics
    import torch
    from mpr_tpu_torch import viewer
    real, real_compose = viewer.compile_tree, viewer.compose
    inner = compile_fn or real
    spent, composing = [], []

    def timed(tree):
        t0 = time.perf_counter()
        try:
            return inner(tree)
        finally:
            spent.append(time.perf_counter() - t0)

    def timed_compose(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_compose(*a, **k)
        torch.cuda.synchronize()
        composing.append(time.perf_counter() - t0)
        return out
    viewer.compile_tree, viewer.compose = timed, timed_compose
    rows = []
    try:
        for i in range(VIEWER_REPS + 2):
            spent.clear()
            composing.clear()
            t0 = time.perf_counter()
            _, ms, _ = viewer.render_scene(src, cam, mode, size, engine,
                                           path)
            wall = (time.perf_counter() - t0) * 1e3
            if i >= 2:
                comp, eff = sum(spent) * 1e3, sum(composing) * 1e3
                rows.append((ms, comp, eff, ms - comp - eff, wall))
    finally:
        viewer.compile_tree, viewer.compose = real, real_compose
    med = [statistics.median(c) for c in zip(*rows)]
    return dict(zip(("frame_ms", "compile_ms", "compose_ms", "render_ms",
                     "wall_ms"), [round(x, 3) for x in med]))


def run_viewer(ctx, results, launches):
    """Phase 16 (b): the viewer (``mpr_tpu_torch/viewer.py``) on the card."""
    import numpy as np
    import mpr_tpu_torch
    from mpr_tpu_torch import viewer
    from mpr_tpu_torch.frontend import shapes
    from mpr_tpu_torch.frontend import tree as T
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.render import pipeline2d
    card, rec = ctx["card"], ctx["rec"]
    out = {"frames": {}}
    seen = {}

    # the 2D frame of phase 2's cell, interpreter engine
    n_blobs, size2 = CASES[0]
    src2 = f"shape = stress_2d({n_blobs})\n"
    cam = viewer.ViewerState().cam
    rec.reset_counts()
    img, ms, _ = viewer.render_scene(src2, cam, "2d", size2, "interp")
    counts = rec.counts()
    for name in KERNELS_2D:
        check(counts[name] >= 1, f"viewer 2D frame: kernel {name} launched "
              f"{counts[name]} times")
    seen["2d"] = counts
    want = pipeline2d.render2d(
        mpr_tpu_torch.compile_tree(shapes.stress_2d(n_blobs)),
        mat=viewer.view_matrix(cam, "2d"), size=size2)
    want = np.where(want[::-1], 255, 0).astype(np.uint8)
    bad = int((img != want).sum())
    check(bad == 0, f"viewer 2D frame: {bad} pixels differ from "
          f"pipeline2d.render2d flipped")
    print(f"viewer stress_2d({n_blobs}) 2d {size2}^2 interp: equal to "
          f"pipeline2d.render2d, launches {counts}")

    # the gyroid scene at the viewer's size in every 3D mode, both engines
    gpath = os.path.join(ROOT, "examples", "gyroid_demo.py")
    with open(gpath) as f:
        gsrc = f.read()
    gshapes, gset = viewer._eval_src(gsrc, gpath)
    st = viewer.ViewerState()
    viewer._apply_script_settings(st, gset)
    gcam, gsize = st.cam, st.size
    check(gsize == VIEWER_SIZE, f"gyroid_demo.py asks for {gsize}")
    images = {}
    for engine in ("interp", "unrolled"):
        for mode in VIEWER_MODES:
            rec.reset_counts()
            reset_generated()
            img, ms, _ = viewer.render_scene(gsrc, gcam, mode, gsize, engine,
                                             gpath)
            hand, gen = rec.counts(), generated_counts()
            if engine == "interp":
                for name in LAUNCHES_3D:
                    check(hand[name] >= 1, f"viewer gyroid {mode} interp: "
                          f"kernel {name} launched {hand[name]} times")
            else:
                for name, n in gen.items():
                    check(n >= 1, f"viewer gyroid {mode} unrolled: {name} "
                          f"launched {n} times")
                check(not any(hand[k] for k in LAUNCHES_3D),
                      f"viewer gyroid {mode} unrolled: an interpreter "
                      f"kernel launched {hand}")
            seen[f"gyroid {mode} {engine}"] = {**hand, **gen}
            want = composed(gshapes, gcam, mode, gsize, engine)
            bad = int((img != want).sum())
            check(bad == 0, f"viewer gyroid {mode} {engine}: {bad} pixels "
                  f"differ from the image composed from render3d and the "
                  f"effects")
            images[engine, mode] = img
    for mode in ("heightmap", "normals"):
        bad = int((images["interp", mode] != images["unrolled", mode]).sum())
        check(bad == 0, f"viewer gyroid {mode}: the engines' images differ "
              f"on {bad} pixels")
    print(f"viewer gyroid_demo.py {gsize}^2 {', '.join(VIEWER_MODES)} on "
          f"both engines: equal to the composed images; heightmap and "
          f"normals equal across the engines")

    # sliders on the unrolled engine: pure data, nothing built
    ppath = os.path.join(ROOT, "examples", "parametric.io")
    with open(ppath) as f:
        psrc = f.read()
    (ptree,), _ = viewer._eval_src(psrc, ppath)
    t0 = time.perf_counter()
    viewer.render_scene(psrc, gcam, "normals", gsize, "unrolled", ppath)
    first_s = time.perf_counter() - t0
    before = (len(ue.BUILDS), len(ue._libs))
    slider_ms = []
    for vv in SLIDER_MOVES:
        reset_generated()
        img, ms, svars = viewer.render_scene(psrc, gcam, "normals", gsize,
                                             "unrolled", ppath,
                                             var_values=vv)
        slider_ms.append(round(ms, 3))
        gen = generated_counts()
        check(all(n >= 1 for n in gen.values()), f"slider {vv}: {gen}")
        check((len(ue.BUILDS), len(ue._libs)) == before, f"slider {vv}: a "
              f"generated kernel was built or loaded")
        check(all(svars[k][0] == v for k, v in vv.items()),
              f"slider {vv}: {svars}")
        want = composed([T.with_params(ptree, vv)], gcam, "normals", gsize,
                        "unrolled")
        bad = int((img != want).sum())
        check(bad == 0, f"slider {vv}: {bad} pixels differ from a fresh "
              f"render of with_params")
    print(f"viewer parametric.io normals {gsize}^2 unrolled: first frame "
          f"{first_s:.2f} s (host clock, its kernels built), "
          f"{len(SLIDER_MOVES)} slider moves {slider_ms} ms built nothing "
          f"and equal fresh renders  [{card}]")
    out["sliders"] = {"first_frame_s": round(first_s, 3),
                      "move_ms": slider_ms}

    out["http"] = run_viewer_http(ctx, gsrc, gpath)

    # frame times: the host's compile_tree share and the rest
    cells = [(f"stress_2d({n_blobs}) 2d {size2}^2 {engine}", src2, cam,
              "2d", size2, engine, "<viewer>")
             for engine in ("interp", "unrolled")]
    cells += [(f"gyroid {mode} {gsize}^2 {engine}", gsrc, gcam, mode, gsize,
               engine, gpath)
              for engine in ("interp", "unrolled") for mode in VIEWER_MODES]
    for label, src, c, mode, size, engine, path in cells:
        r = frame_times(src, c, mode, size, engine, path)
        out["frames"][label] = r
        print(f"viewer frame {label}: {r['frame_ms']:.3f} ms (compile_tree "
              f"{r['compile_ms']:.3f} ms on the host, compose "
              f"{r['compose_ms']:.3f} ms, the rest {r['render_ms']:.3f} "
              f"ms), {r['wall_ms']:.3f} ms with the script's evaluation; "
              f"median of {VIEWER_REPS}  [{card}]")
    from mpr_tpu_torch.tape.tape import compile_tree
    label = cells[0][0] + ", Python passes"
    r = frame_times(*cells[0][1:], compile_fn=lambda t: compile_tree(
        t, backend="python"))
    out["frames"][label] = r
    print(f"viewer frame {label}: {r['frame_ms']:.3f} ms (compile_tree "
          f"{r['compile_ms']:.3f} ms, the rest {r['render_ms']:.3f} ms), "
          f"{r['wall_ms']:.3f} ms with the script's evaluation  [{card}]")
    out["host_cpu"] = host_cpu()
    launches["viewer"] = seen
    results["viewer"] = out


def run_viewer_http(ctx, gsrc, gpath):
    """Phase 16 (b), the HTTP loop: the render thread runs on a stream of
    its own; the page, a frame, an engine switch traced with torch.profiler
    (every kernel of ours on the thread's stream), then an edited script
    whose unrolled kernels build in that thread, its frame decoded against
    render_scene."""
    import http.client
    import http.server
    import json as _json
    import threading
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mpr_tpu_torch import viewer
    from mpr_tpu_torch.io.png import decode_png
    card, dev = ctx["card"], ctx["dev"]
    state = viewer.ViewerState(device=dev)
    state.path, state.src = gpath, gsrc
    _, settings = viewer._eval_src(gsrc, gpath)
    viewer._apply_script_settings(state, settings)
    state.mode, state.engine = "shaded", "interp"
    side = torch.cuda.Stream()

    ident = {}

    def work():
        ident["worker"] = threading.get_ident()
        with torch.cuda.stream(side):
            viewer._render_worker(state)
    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    state.dirty.set()
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                            viewer.make_handler(state))
    port = httpd.server_address[1]
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()

    def get(p):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("GET", p)
        r = c.getresponse()
        return r.status, r.read()

    def post(body):
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        c.request("POST", "/update", _json.dumps(body))
        r = c.getresponse()
        r.read()
        return r.status

    def wait_seq(n, timeout=VIEWER_WAIT_S):
        t_end = time.perf_counter() + timeout
        while time.perf_counter() < t_end:
            st = _json.loads(get("/status")[1])
            if st["seq"] >= n and not state.dirty.is_set():
                with state.lock:
                    if state.seq >= n and not state.dirty.is_set():
                        return st
            time.sleep(0.05)
        raise SmokeError(f"viewer HTTP loop: no frame {n} within "
                         f"{timeout:.0f} s")

    try:
        st = wait_seq(1)
        check(st["error"] == "", f"viewer HTTP loop: {st['error']}")
        status, page = get("/")
        check(status == 200 and b"textarea" in page,
              "viewer HTTP loop: GET / did not return the page")
        # an engine switch and back: both engines' kernels must launch on
        # the render thread's stream.  Every wrapper passes its kernel the
        # stream torch.cuda.current_stream() gives where it runs: record
        # what that gave the wrappers in the render thread (all of it must
        # be the thread's stream), and trace the same frames with
        # torch.profiler against marker kernels of two lengths, a long one
        # on the thread's stream and a short one on the main thread's.
        real_current = torch.cuda.current_stream
        asked = []

        def spy(device=None):
            stream = real_current(device)
            caller = sys._getframe(1).f_code.co_filename
            if os.path.join("mpr_tpu_torch", "ops") in caller:
                asked.append((threading.get_ident(),
                              os.path.basename(caller), stream.cuda_stream))
            return stream

        def markers():
            with torch.cuda.stream(side):
                torch.cuda._sleep(MARKER_CYCLES[0])
            torch.cuda._sleep(MARKER_CYCLES[1])
            torch.cuda.synchronize()

        traced = None
        for attempt in range(3):
            asked.clear()
            torch.cuda.current_stream = spy
            try:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    markers()
                    check(post({"engine": "unrolled"}) == 200, "POST engine")
                    st = wait_seq(st["seq"] + 1)
                    check(post({"engine": "interp"}) == 200, "POST engine")
                    st = wait_seq(st["seq"] + 1)
                    markers()
            finally:
                torch.cuda.current_stream = real_current
            check(st["error"] == "", f"viewer HTTP loop: {st['error']}")
            mine = [(f, h) for t, f, h in asked if t == ident["worker"]]
            check({f for f, _ in mine} >= {"kernels.py", "unrolled_eval.py"},
                  f"viewer render thread: the hand-written and generated "
                  f"kernels' wrappers did not both launch there ({mine[:4]})")
            check({h for _, h in mine} == {side.cuda_stream},
                  f"viewer render thread: a wrapper launched on another "
                  f"stream than the thread's ({sorted({h for _, h in mine})}"
                  f" against {side.cuda_stream})")
            kern = [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA]
            spins = [e for e in kern if "spin" in e.name
                     or "sleep" in e.name]
            long_ids = {e.device_resource_id for e in spins
                        if e.time_range.elapsed_us() >= MARKER_SPLIT_US}
            short_ids = {e.device_resource_id for e in spins
                         if e.time_range.elapsed_us() < MARKER_SPLIT_US}
            ours = {}
            for e in kern:
                for name in HAND_KERNELS + (GENERATED_KERNEL,):
                    if name in e.name:
                        ours.setdefault(name, set()).add(
                            e.device_resource_id)
            print(f"viewer render thread, trace {attempt + 1}: "
                  f"{len(mine)} launches asked for the thread's stream; "
                  f"stream ids of our kernels {ours}, of the markers on the "
                  f"thread's stream {sorted(long_ids)} and on the main "
                  f"thread's {sorted(short_ids)}")
            check(len(long_ids) <= 1 and not (long_ids & short_ids) and all(
                ids <= long_ids for ids in ours.values()) if long_ids
                else True, f"viewer render thread: a kernel ran on another "
                f"stream than the thread's ({ours}, {long_ids})")
            if (long_ids and short_ids and GENERATED_KERNEL in ours
                    and all(k in ours for k in LAUNCHES_3D_KERNELS)):
                traced = sorted(long_ids)
                break
        if traced is None:
            print("viewer render thread: three traces dropped a marker or a "
                  "kernel's record; the stream is held by the launches' "
                  "arguments only (above)")
        # an edited script on the unrolled engine: its kernels build cold in
        # the render thread
        t0 = time.perf_counter()
        check(post({"script": VIEWER_EDIT, "engine": "unrolled",
                    "mode": "2d"}) == 200, "POST script")
        st = wait_seq(st["seq"] + 1)
        edit_s = time.perf_counter() - t0
        check(st["error"] == "", f"viewer HTTP loop, edited script: "
              f"{st['error']}")
        status, png = get("/frame.png")
        check(status == 200, "GET /frame.png")
        want, _, _ = viewer.render_scene(VIEWER_EDIT, st["cam"], st["mode"],
                                         st["size"], st["engine"])
        img = decode_png(png)
        check(img.shape == want.shape and bool(np.array_equal(img, want)),
              "viewer HTTP loop: /frame.png differs from render_scene")
        print(f"viewer HTTP loop on 127.0.0.1:{port}: page, frames, engine "
              f"switch on the render thread's stream; an edit on the "
              f"unrolled engine (cold build) answered in {edit_s:.2f} s, "
              f"/frame.png equal to render_scene  [{card}]")
        return {"edit_s": round(edit_s, 3), "traced_stream": traced,
                "streams": {k: sorted(v) for k, v in ours.items()}}
    finally:
        state.stop.set()
        state.dirty.set()
        worker.join(timeout=VIEWER_WAIT_S)
        httpd.shutdown()
        httpd.server_close()
        server.join()


def run_fit(ctx, results, launches, pre):
    """Phase 14: mesh export, the five fit steps on K1 and K2, the sharded
    render and step under a process group of one (NCCL), and ``cli fit``
    / ``cli mesh`` as subprocesses."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from mpr_tpu_torch.io import mesh as mmesh
    from mpr_tpu_torch.ops import build, eval_scan
    from mpr_tpu_torch.ops import launch as ln
    from mpr_tpu_torch.ops import unrolled_eval as ue
    from mpr_tpu_torch.ops.tape_data import TapeData
    from mpr_tpu_torch.parallel import sharded
    from mpr_tpu_torch.render import brute, camera, pipeline2d, pipeline3d
    card, dev = ctx["card"], ctx["dev"]
    pre["thread"].join()
    if "error" in pre:
        raise pre["error"]
    cells = dict(pre["cells"])
    print(f"fit phase: {len(pre['evals'])} generated kernels built in "
          f"{pre['seconds']:.1f} s (beside phases 1 and 13)  [{card}]")
    builds, k1_spills = {}, []
    for ev in [k for e in pre["evals"] for k in e.kernels()]:
        b = ue.BUILDS[ev.key]
        regs, stack, spill = ptxas_of(b["log"])
        cell = next(c for c, t in pre["cells"] if t is ev.tape)
        kind = ev.kind if ev.kind != "vjp" else f"vjp{ev.seg}"
        if ev.kind in ("float", "interval", "deriv"):
            kind = f"{ev.kind} {ev.form.tag}"
        builds.setdefault(cell, {})[kind] = dict(
            seconds=round(b["seconds"], 2), registers=regs, stack=stack,
            spills=spill)
        print(f"  build {cell} {kind}: {ev.tape.length} clauses, "
              f"{b['seconds']:.1f} s of nvcc; {regs} registers, {stack} B "
              f"stack, spill stores/loads {spill} B")
        if ev.kind in ("vjp", "vjpf") and spill != "0/0":
            k1_spills.append(f"{cell} {kind}: {spill} B")
        if ev.kind in ("float", "interval", "deriv") and spill != "0/0":
            results["unrolled_spills"].append(f"{cell} {kind} (imms from a "
                                              f"pointer): {spill} B")
    results["k1_spills"] = k1_spills
    for cell, tape in pre["cells"]:
        vjp = ue.build_float(tape, take_imms=True).vjp
        plan, sh = vjp.plan, vjp.shape
        regs = [builds[cell][f"vjp{sg}"]["registers"] for sg in plan.segments]
        print(f"K1 launch shape at {cell}: forward half a thread a lane "
              f"({ue.ln.UNROLLED_THREADS} threads a block; "
              f"{builds[cell]['vjpf']['registers']} registers), "
              f"{len(plan.segments)} reverse segments of {sh['segment']} "
              f"clauses ({sh['threads']} threads a block, launch bounds for "
              f"{sh['min_blocks']} blocks an SM, at most {sh['live']} "
              f"adjoints in registers; registers {regs}); plan: "
              f"{plan.n_vals} values, {plan.n_words} choice words, "
              f"{plan.n_handover} adjoints handed over ({plan.contributions} "
              f"writes) a lane  [{card}]")
    k2_regs = {}
    for lib_name, log in sorted(build.BuildStats.log.items()):
        for kern, k, bucket, regs, stack, st, ld in ptxas_rows(log):
            if kern == "scan_adjoint_kernel":
                k2_regs[(k, bucket)] = regs

    # ---- mesh export on the card ---------------------------------------------
    # The gyroid scene at n=128, both methods.  mpr_tpu's own meshes of it
    # (the same NumPy on its oracle) are not watertight by is_watertight at
    # n=64 and 128, nor is its dc mesh of the drilled sphere at 128; the
    # shapes whose meshes it closes are held to watertight here.
    import mpr_tpu_torch
    from mpr_tpu_torch.frontend import shapes
    gname = CASES_3D[0][0]
    gtape = cells[gname]
    closed = {"mt": ("drilled sphere", shapes.difference(
                  shapes.sphere(0.7), shapes.cylinder_z(0.3, -1, 1))),
              "dc": ("sphere", shapes.sphere(0.6))}
    mesh_rows = {}
    for method in ("mt", "dc"):
        for name, tape, must_close in (
                (gname, gtape, False),
                (closed[method][0],
                 mpr_tpu_torch.compile_tree(closed[method][1]), True)):
            with Counts() as c:
                t0 = time.perf_counter()
                tris = mmesh.mesh_tape(tape, n=MESH_N, method=method)
                secs = time.perf_counter() - t0
            tight = mmesh.is_watertight(tris)
            vol = mmesh.mesh_volume(tris)
            mesh_rows[f"{name} {method}"] = dict(
                triangles=len(tris), seconds=round(secs, 3),
                watertight=tight, volume=vol, launches=c.read)
            print(f"mesh {name} n={MESH_N} {method}: {len(tris)} triangles, "
                  f"watertight {tight}, volume {vol:.5f}, {secs:.2f} s "
                  f"(host clock; the first call builds the baked "
                  f"evaluators); launches {c.read}  [{card}]")
            check(len(tris) > 1000 and vol > 0, f"mesh {method} of {name} "
                  "is empty or inside out")
            check(c.read["plain"] == 0, "mesh export ran a plain evaluator")
            check(c.read["unrolled_float"] > 0 and (
                method == "mt" or c.read["unrolled_deriv"] > 0),
                f"mesh {method} launched no generated kernel")
            check(tight or not must_close, f"the {method} mesh of {name} "
                  "is not watertight")
    results["mesh"] = mesh_rows

    # ---- the five fit steps ----------------------------------------------------
    rng = np.random.default_rng(14)

    def perturbed(tape):
        return dataclasses.replace(tape, imms=(tape.imms * (
            1.0 + 0.02 * rng.standard_normal(tape.length))).astype(
                np.float32))
    sname = f"stress_2d({CASES[0][0]})"
    stape, etape = cells[sname], cells[CASES_3D[1][0]]
    fills = {}
    for size in (FIT_2D, FIT_2D_BIG):
        fills[size] = torch.as_tensor(pipeline2d.render2d(
            perturbed(stape), size=size), dtype=torch.float32, device=dev)
    depth_grid = torch.as_tensor(brute.render3d_brute(
        perturbed(gtape), size=FIT_GRID), dtype=torch.float32, device=dev)
    depth_window = torch.as_tensor(pipeline3d.render3d(
        perturbed(etape), size=FIT_WINDOW, with_normals=False)[0],
        dtype=torch.float32, device=dev)
    s2, s2b = FIT_2D, FIT_2D_BIG
    fits = [
        # label, engine, tape, make(lr) -> step, initial state, target
        (f"scan {s2}^2", "scan", stape,
         lambda lr: sharded.make_fit_step(s2, lr=lr),
         lambda: TapeData.from_tape(stape), fills[s2]),
        (f"unrolled {s2}^2", "unrolled", stape,
         lambda lr: sharded.make_fit_step_unrolled(stape, s2, lr=lr),
         lambda: torch.as_tensor(stape.imms, device=dev), fills[s2]),
        (f"culled {s2}^2", "culled", stape,
         lambda lr: sharded.make_fit_step_culled(stape, s2, lr=lr),
         lambda: torch.as_tensor(stape.imms, device=dev), fills[s2]),
        (f"culled {s2b}^2", "culled", stape,
         lambda lr: sharded.make_fit_step_culled(stape, s2b, lr=lr),
         lambda: torch.as_tensor(stape.imms, device=dev), fills[s2b]),
        (f"3d grid={FIT_GRID}", "3d", gtape,
         lambda lr: sharded.make_fit_step_3d(gtape, FIT_GRID, lr=lr),
         lambda: torch.as_tensor(gtape.imms, device=dev), depth_grid),
        (f"3d window {FIT_WINDOW}", "window", etape,
         lambda lr: sharded.make_fit_step_3d_window(etape, FIT_WINDOW,
                                                    lr=lr),
         lambda: torch.as_tensor(etape.imms, device=dev), depth_window),
    ]
    # the JAX package's default rates (cli fit's for the window), but the
    # dense 3D fit's on the gyroid: its gradient is about 100 (thin
    # sheets), and at 3e-4 the loss went 54.3, 51.1, 51.6, 57.4 (H100)
    lrs = {"scan": 1e-2, "unrolled": 1e-2, "culled": 1e-2, "3d": 3e-5,
           "window": 2e-5}
    probe_lr = 2.0 ** 20
    fit_rows, kcalls = {}, {k: [] for k, *_ in FIT_ROWS}
    recorder = Recorder({"unrolled_eval": ue, "eval_scan": eval_scan},
                        FIT_ROWS)
    for label, engine, tape, make, init, target in fits:
        # the gradient at the first step, kernels against plain versions
        # (a step at lr 2**20 moves the immediates by 2**20 x the
        # gradient, so (imms - new) / lr recovers it to float32 precision)
        st0 = init()
        base = (st0.imms if isinstance(st0, TapeData) else st0).double()
        log = {}
        recorder.install(log)
        try:
            with Counts() as c:
                _, new = make(probe_lr)(st0, target)
                torch.cuda.synchronize()
        finally:
            recorder.remove()
        new = new.imms if isinstance(new, TapeData) else new
        g_kernel = (base - new.double()) / probe_lr
        check(c.read["plain"] == 0, f"fit {label} ran a plain evaluator")
        kname = "scan_adjoint" if engine == "scan" else "unrolled_float_vjp"
        check(c.read[kname] > 0, f"fit {label} launched no {kname}")
        real = (ue.unrolled_float_vjp, eval_scan.scan_adjoint)

        def plain_k1(ev, x, y, z, g, imms):
            return plain_vjp_unrolled(ue, ev, x, y, z, g, imms)

        def plain_k2(td, x, y, z, g, store=None):
            return plain_vjp_scan(eval_scan, td, x, y, z, g)
        ue.unrolled_float_vjp, eval_scan.scan_adjoint = plain_k1, plain_k2
        try:
            _, newp = make(probe_lr)(init(), target)
        finally:
            ue.unrolled_float_vjp, eval_scan.scan_adjoint = real
        newp = newp.imms if isinstance(newp, TapeData) else newp
        g_plain = (base - newp.double()) / probe_lr
        n = tape.length
        gmax = float(g_plain[:n].abs().max())
        gerr = float((g_kernel[:n] - g_plain[:n]).abs().max())
        print(f"fit {label}: first-step gradient, kernels against plain "
              f"versions: max |diff| {gerr:.3e} of max |g| {gmax:.3e}; "
              f"launches {c.read}")
        check(gmax > 0 and gerr <= FIT_GRAD_TOL * gmax, f"fit {label}: the "
              f"kernels' gradient differs from the plain one by {gerr} "
              f"(max |g| {gmax})")
        for k, *_ in FIT_ROWS:
            for a, kw, out in log.get(k, []):
                kcalls[k].append((label, tape, a, kw, out))

        # the loss over FIT_STEPS steps at the default rate, each timed
        step, st = make(lrs[engine]), init()
        losses, ms = [], []
        with Counts() as c:
            for _ in range(FIT_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, st = step(st, target)
                losses.append(float(loss))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        st0 = init()
        step_ms = cuda_ms(lambda: step(st0, target), 3, 1)
        print(f"fit {label}: losses {['%.6g' % v for v in losses]}, step "
              f"{['%.1f' % v for v in ms]} ms (host clock), steady step "
              f"{step_ms:.3f} ms (events, median of 3); launches over "
              f"{FIT_STEPS} steps {c.read}  [{card}]")
        check(c.read["plain"] == 0, f"fit {label} ran a plain evaluator")
        check(c.read[kname] >= FIT_STEPS, f"fit {label}: {kname} launched "
              f"{c.read[kname]} times in {FIT_STEPS} steps")
        check(losses[-1] < losses[0], f"fit {label}: the loss did not fall "
              f"({losses})")
        fit_rows[label] = dict(engine=engine, losses=losses, step_ms=ms,
                               steady_step_ms=step_ms, launches=c.read,
                               grad_err=gerr, grad_max=gmax,
                               counts=getattr(step, "last_counts", None))
    results["fits"] = fit_rows
    launches["fit"] = {k: sum(r["launches"][k] for r in fit_rows.values())
                       for k, *_ in FIT_ROWS}

    # ---- each backward kernel against its plain version, timed ---------------
    rows = {}
    for kname, _, short, source, replaces in FIT_ROWS:
        per = {}
        for label, tape, a, kw, out in kcalls[kname]:
            if label in per:
                continue            # the first launch of each fit
            shape, floor = None, 0
            if kname == "unrolled_float_vjp":
                ev, x, y, z, g, imms = a
                run = (lambda: ue.unrolled_float_vjp(ev, x, y, z, g, imms))
                plain = (lambda: plain_vjp_unrolled(ue, ev, x, y, z, g,
                                                    imms))
                lanes = x.numel()
                ops = lanes * vjp_ops(tape)
                floor = ev.plan.k1_floor_bytes(lanes)
                shape = dict(ev.shape, chunks=-(-lanes // ue.vjp_chunk(
                    ev.plan, lanes)))
            elif kname == "scan_adjoint":
                td, x, y, z, g = a
                run = (lambda: eval_scan.scan_adjoint(td, x, y, z, g))
                plain = (lambda: plain_vjp_scan(eval_scan, td, x, y, z, g))
                lanes = x.numel()
                ops = lanes * vjp_ops(tape)
                floor = td.vjp_plan()[0].k2_floor_bytes(lanes)
                s_cap = eval_scan.adjoint_s_cap(td)
                pick = ln.adjoint_launch(s_cap, td.length)
                shape = dict(home=pick.home, threads=pick.threads, k=pick.k,
                             smem=pick.smem, bucket=pick.bucket, s_cap=s_cap,
                             registers=k2_regs.get((pick.k, pick.bucket)))
                print(f"K2 launch shape at {label}: {shape}  [{card}]")
            else:
                # the step's K2f launch (storing the plan for K2, kept for
                # the backward pass), and the plain walk of the same lanes
                # (the launch the step made before it stored in forward)
                td, x, y, z = a[:4]
                rr = k2f_launch(f"the {label} fit", td, x, y, z, True, card)
                st = k2f_store(td, x.numel())
                rr["ms"] = cuda_ms(lambda: eval_scan.scan_eval(
                    td, x, y, z, store=st), 5, 1)
                rr["launch_shape"] = rr["shape"]
                rr["plain_walk"] = k2f_launch(f"the {label} fit (not "
                                              "storing)", td, x, y, z, False,
                                              card)
                per_step = fit_rows[label]["launches"]["scan_eval"] / FIT_STEPS
                kept = sum(t.numel() * 4 for t in eval_scan.k2_store(
                    td, x.numel()))
                first_step = (rr["first_device_ms"] or 0.0) + (
                    rr["plain_walk"]["first_device_ms"] or 0.0)
                rr["step"] = dict(launches=per_step,
                                  device_ms=rr["device_ms"] * per_step
                                  if rr["device_ms"] else None,
                                  first_design_device_ms=first_step,
                                  kept_store_bytes=kept)
                print(f"  K2f a {label} step: {per_step:g} launch(es) "
                      f"(storing; the backward pass reads the store, "
                      f"{kept} B held between the passes), device "
                      f"{rr['step']['device_ms']} ms; the first design's "
                      f"two launches (walk, then the store) {first_step:.6f}"
                      f" ms  [{card}]")
                per[label] = rr
                del st
                continue
            got = run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = plain()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            diff = torch.where(torch.isnan(got) & torch.isnan(want), 0.0,
                               (got - want).abs())
            err = float(diff.max())
            scale = float(want.abs().max())
            tol = FIT_GRAD_TOL * scale
            check(err <= tol, f"{kname} ({label}) differs from its plain "
                  f"version by {err} (largest {scale})")
            rr = dict(lanes=lanes, clauses=tape.length, max_abs_err=err,
                      bytes=lanes * 16 + tape.length * 8, ops=ops)
            if shape is not None:
                rr["launch_shape"] = shape
                # the design's own floor: what it stores and hands over,
                # each written and read once, beside the function's bound
                rr["floor_ms"] = (floor + rr["bytes"]) / PEAK_BYTES_PER_S * 1e3
            rr["ms"] = cuda_ms(run, 5, 1)
            rr.update(half_ms(kname, a, ue, eval_scan))
            _, prow, _ = profile_frames(run, 3)
            rr["device_ms"] = (round(sum(v for _, v in prow), 6) if prow
                               else None)
            # the plain version's one run above (host clock, synchronised;
            # several seconds at the large fits)
            rr["plain_ms"] = plain_s * 1e3
            rr["bound_ms"], rr["bound_by"] = bound(rr)
            per[label] = rr
            floor_txt = (f", the design's own byte floor "
                         f"{rr['floor_ms']:.5f} ms" if "floor_ms" in rr
                         else "")
            if "forward_ms" in rr:
                floor_txt += ("; its forward half alone "
                              f"{rr['forward_ms']:.4f} ms (events)")
            print(f"  {short} {kname} {label}: {lanes} lanes x "
                  f"{tape.length} clauses, {rr['ms']:.4f} ms (events; "
                  f"device, all kernels of the call, {rr['device_ms']}), "
                  f"plain {rr['plain_ms']:.1f} ms, bound "
                  f"{rr['bound_ms']:.5f} ms ({rr['bound_by']}){floor_txt}, "
                  f"max |err| {err:.3e} of {scale:.3e}  [{card}]")
            if kname == "scan_adjoint":
                rr["sweep"] = sweep_k2(eval_scan, ln, td, x, y, z, g, want,
                                       card)
            del got, want
        check(per, f"no launch of {kname} was recorded in the fit phase")
        rows[kname] = per

    # ---- sharded render and step under a process group of one (NCCL) -------
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    st0 = torch.as_tensor(stape.imms, device=dev)
    l0, n0 = sharded.make_fit_step_unrolled(stape, FIT_2D)(st0,
                                                           fills[FIT_2D])
    dist.init_process_group(FIT_BACKEND,
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = sharded.make_mesh()
        size2 = CASES[0][1]
        for eng, fn in (("interp", sharded.render2d_sharded),
                        ("unrolled", sharded.render2d_sharded_unrolled)):
            img = fn(stape, size=size2, mesh=mesh)
            bad = int((img != ctx["images2d"][size2]).sum())
            print(f"sharded render2d ({eng}, {FIT_BACKEND} group of 1) "
                  f"@{size2}: "
                  f"{bad} pixels differ from the one-device image")
            check(bad == 0, f"the sharded {eng} 2D render differs")
        d, _ = sharded.render3d_sharded_unrolled(
            etape, camera.gui3d_view(*CASES_3D[1][2]), size=CASES_3D[1][3],
            mesh=mesh)
        want = ctx["frames3d"][CASES_3D[1][0]][0]
        bad = int((d != want).sum())
        print(f"sharded render3d (unrolled, {FIT_BACKEND} group of 1) @"
              f"{CASES_3D[1][3]}: {bad} pixels differ from the interpreter")
        check(bad == 0, "the sharded unrolled 3D render differs")
        l1, n1 = sharded.make_fit_step_unrolled(stape, FIT_2D, mesh)(
            st0, fills[FIT_2D])
        print(f"sharded fit step (unrolled, {FIT_BACKEND} group of 1): loss "
              f"{float(l1):.9g} vs one device {float(l0):.9g}, imms equal "
              f"{bool(torch.equal(n1, n0))}")
        check(float(l1) == float(l0) and torch.equal(n1, n0),
              "the sharded fit step differs from the one-device step")
    finally:
        dist.destroy_process_group()

    # ---- the command line: every way into fit and mesh, in parallel --------
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        from mpr_tpu_torch import cli
        from mpr_tpu_torch.frontend import frep, shapes
        from mpr_tpu_torch.io import checkpoint
        gpath = os.path.join(tmp, f"{gname}.frep")
        frep.dump([frep.ArchiveShape(tree=CASES_3D[0][1](shapes),
                                     name=gname)], gpath)
        scene = os.path.join(tmp, "param.io")
        with open(scene, "w") as fh:
            fh.write("(circle (var r 0.4) [0.1 0])\n(circle 0.2 [-0.5 0])\n")
        base = ["fit", "stress:40", "--target", "stress:41", "--steps", "3"]
        runs = [base + ["--engine", eng, "--out", f"f_{eng}.npz"]
                for eng in ("scan", "unrolled", "culled")]
        runs += [base + ["--mode", "3d", "--engine", eng, "--out",
                         f"f3_{eng}.npz"] for eng in ("scan", "culled")]
        runs += [["fit", scene, "--target", "stress:41", "--steps", "3",
                  "--params-only", "--out", "f_params.npz"]]
        runs += [["mesh", gpath, "--size", "96", "--method", m, "--out",
                  os.path.join(tmp, f"g_{m}.stl")] for m in ("mt", "dc")]
        runs += [["render2d", "stress:40", "--size", "256", "--sharded",
                  "--engine", eng, "--check", "--out", f"s_{eng}.png"]
                 for eng in ("interp", "unrolled")]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-m", "mpr_tpu_torch.cli",
                                   *argv, *CLI_EXTRA], cwd=tmp, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for argv in runs]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        print(f"cli: {len(runs)} runs in parallel, {time.perf_counter() - t0:.1f}"
              f" s  [{card}]")
        for argv, p, (so, se) in zip(runs, procs, outs):
            shown = (argv if argv[0] != "mesh" else
                     [argv[0], os.path.basename(argv[1])] + argv[2:-2])
            print(f"cli {' '.join(shown)}: exit {p.returncode}")
            for line in so.strip().splitlines():
                print("    " + line)
            check(p.returncode == 0, f"cli {argv[0]} failed:\n{se}")
            if argv[0] == "fit":
                ls = [float(ln.split()[-1]) for ln in so.splitlines()
                      if ln.startswith("step ")]
                check(len(ls) == 3, f"cli fit printed {len(ls)} steps")
            elif argv[0] == "render2d":
                check("oracle cross-check: mismatch 0.00e+00" in so,
                      "cli render2d --sharded printed no exact cross-check")
            else:
                tris = mmesh.read_stl(argv[-1])
                check(len(tris) > 0 and mmesh.mesh_volume(tris) > 0,
                      "cli mesh wrote an empty mesh")
        ptape = cli._load(scene)
        fitted = checkpoint.load_tape(os.path.join(tmp, "f_params.npz"))
        moved = set(np.flatnonzero(fitted.imms != ptape.imms).tolist())
        print(f"cli fit --params-only: moved immediates {sorted(moved)}, "
              f"the parameter's {ptape.params['r']}")
        check(moved and moved <= set(ptape.params["r"]),
              "cli fit --params-only moved other immediates")

    # ---- the kernels line's rows -------------------------------------------------
    out = []
    for kname, _, short, source, replaces in FIT_ROWS:
        per = rows[kname]
        at = max(per, key=lambda c: per[c]["ms"])
        p = per[at]
        out.append({
            "name": kname, "kernel": short, "route": "cuda",
            "source": source, "replaces": replaces, "port_kernel": True,
            "launches": launches["fit"][kname],
            "max_abs_err": max(x["max_abs_err"] for x in per.values()),
            "ms": round(p["ms"], 6), "plain_ms": round(p["plain_ms"], 3),
            "bound_ms": round(p["bound_ms"], 6), "bound_by": p["bound_by"],
            "library_ms": None, "at": at,
            "floor_ms": (round(p["floor_ms"], 6) if "floor_ms" in p
                         else None),
            "launch_shape": p.get("launch_shape"),
            "per_fit": {c: {k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in x.items()} for c, x in per.items()},
            "build_s": {c: {k: v["seconds"] for k, v in b.items()
                            if k.startswith("vjp")}
                        for c, b in builds.items()}
            if kname == "unrolled_float_vjp" else None})
    results["fit_rows"] = out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mpr_tpu_torch.render.unrolled  # noqa: F401  (phase 13)
        from mpr_tpu_torch.ops import build
        from mpr_tpu_torch.ops import kernels as tk
        from mpr_tpu_torch.ops import kernels3d as tk3
        from mpr_tpu_torch.ops.tape_data import resolve_device
        from mpr_tpu_torch.utils.trace import COUNTS
    except ImportError as e:
        print(f"chip_smoke: the mpr_tpu_torch package is missing ({e}); "
              "run from the repository root", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {kind}")

    # ---- 1. build (phase 13's and 14's generated kernels start building too)
    pre = _PRE["box"] = start_unrolled_builds()
    pre14 = _PRE["box14"] = start_fit_builds()
    for lib_name in build.LIBRARIES:
        build.lib(lib_name)
        print(f"build {lib_name}: {build.BuildStats.seconds[lib_name]:.1f} s"
              f" (compiles so far {COUNTS['builds.compile']}, loads "
              f"{COUNTS['builds.load']})", flush=True)
    source = ""
    for line in build.BuildStats.log["main"].splitlines():
        if line.startswith("=="):
            source = line
            print("  " + line.strip())
        elif ("registers" in line or "spill" in line) and not any(
                n in source for n in ("voxel_eval", "deriv_eval",
                                      "pixel_eval", "interval_shorten",
                                      "compact", "scan_adjoint",
                                      "scan_eval")):
            print("  " + line.strip())
    spills = print_ptxas(tk3, build.BuildStats.log)

    ctx = {"tk": tk, "tk3": tk3, "dev": resolve_device(), "card": card,
           "rec": Recorder({"kernels": tk, "kernels3d": tk3}),
           "builds": (COUNTS['builds.load'], COUNTS['builds.compile'])}
    results, launches = {}, {}
    print(f"phase 1 (build): {time.perf_counter() - t_start:.1f} s since "
          "the start", flush=True)
    phases = (("2d", run_2d, (results, launches)), ("stale imms",
              run_stale_imms, ()), ("3d", run_3d, (results, launches)),
              ("k2f", run_k2f, (results,)), ("edges", run_edges, (results,)),
              ("v1", run_v1, (results, launches)),
              ("cli", run_cli, (launches,)), ("effects", run_effects, ()),
              ("unrolled", run_unrolled, (results, launches, pre)),
              ("options", run_options, (results, launches)),
              ("native", run_native, (results,)),
              ("viewer", run_viewer, (results, launches)),
              ("fit", run_fit, (results, launches, pre14)))
    for name, fn, args in phases:
        t0 = time.perf_counter()
        got = fn(ctx, *args)
        if name == "effects":
            effect_rows = got
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)

    check(not spills, f"kernel A, B, B1, C, C2, C1, V, D, K2f or K2 spills "
          f"registers: {spills}")
    check(not results["k1_spills"], f"kernel K1 spills registers: "
          f"{results['k1_spills']}")
    # every generated evaluator this run built, those built at first use
    # (the meshes' normals) too
    from mpr_tpu_torch.ops import unrolled_eval as ue
    late = sorted({f"{b['kind']} {b['form']} of a {b['clauses']}-clause "
                   f"tape: {ptxas_of(b['log'])[2]} B"
                   for b in ue.BUILDS.values()
                   if b["kind"] in ("float", "interval", "deriv")
                   and ptxas_of(b["log"])[2] != "0/0"
                   and not first_design_spills(b["kind"], b["form"])})
    check(not results["unrolled_spills"] and not late, f"a generated float, "
          f"interval or deriv kernel spills registers: "
          f"{results['unrolled_spills'] + late}")

    # ---- 12. report -------------------------------------------------------------
    size = CASES[0][1]
    name3 = CASES_3D[0][0]
    n3 = len(CASES_3D)
    rows = []
    for name, _, source, replaces in KERNEL_ROWS:
        per_3d = [results[c][name] for c, *_ in CASES_3D if name in results[c]]
        flat_3d = [r for x in per_3d for r in (x if isinstance(x, list)
                                               else [x])]
        if name in KERNELS_V1:
            # no render path calls it: launched by the kernel phase, on the
            # 2D cell's recorded data
            r = results["v1"][name]
            at = f"stress_2d({CASES[0][0]}) {size}^2"
            errs = [r["max_abs_err"]]
            extra = {"launches_per_frame": 0, "device_ms": r["device_ms"],
                     "launched_by": "kernel phase (no render path calls it)"}
            if "ms_cap8" in r:
                extra["ms_cap8"] = r["ms_cap8"]
            for key in ("kernel_b_device_ms", "kernel_c_device_ms",
                        "vs_kernel", "prepass", "long_tape_device_ms"):
                if key in r:
                    extra[key] = r[key]
        elif name in KERNELS_2D:
            # timed at the 2D cell, as before; the 3D launches ride along
            r = results[size][name]
            at = f"stress_2d({CASES[0][0]}) {size}^2"
            errs = [results[s][name]["max_abs_err"] for _, s in CASES]
            r2 = results[CASES[1][1]][name]
            extra = {"ms_2048": r2["ms"], "device_ms": r["device_ms"],
                     "device_ms_2048": r2["device_ms"],
                     "bound_ms_2048": bound(r2)[0]}
            if name == "compact_bitshift_batched":
                extra["share_of_bound"] = {
                    f"stress_2d({nb}) {sz}^2":
                        results[sz][name]["share_of_bound"]
                    for nb, sz in CASES}
                for c, *_ in CASES_3D:
                    extra["share_of_bound"][c] = [
                        x["share_of_bound"] for x in results[c][name]]
                    extra[f"prepass_{c}"] = results[c]["prepass"]
            if name == "interval_shorten":
                extra.update(levels=r["levels"],
                             dep_bound_ms=r["dep_bound_ms"],
                             levels_2048=results[CASES[1][1]][name]["levels"],
                             dep_bound_ms_2048=results[CASES[1][1]][name][
                                 "dep_bound_ms"])
            if flat_3d:
                for c, *_ in CASES_3D:
                    extra[f"ms_{c}"] = [x["ms"] for x in results[c][name]]
                    extra[f"device_ms_{c}"] = [x["device_ms"]
                                               for x in results[c][name]]
                    extra[f"bound_ms_{c}"] = [bound(x)[0]
                                              for x in results[c][name]]
                    if name == "interval_shorten":
                        extra[f"dep_bound_ms_{c}"] = [
                            x["dep_bound_ms"] for x in results[c][name]]
        else:
            r = results[name3][name]
            at = f"{name3} {CASES_3D[0][3]}^3"
            errs = []
            other = CASES_3D[1][0]
            ro = results[other][name]
            extra = {"rows": r["rows"], f"ms_{other}": ro["ms"],
                     "device_ms": r["device_ms"],
                     f"device_ms_{other}": ro["device_ms"],
                     f"plain_ms_{other}": ro["plain_ms"],
                     f"bound_ms_{other}": bound(ro)[0],
                     f"bound_by_{other}": bound(ro)[1],
                     f"rows_{other}": ro["rows"],
                     "launch_shapes": {c: results[c]["shapes"][name]
                                       for c, *_ in CASES_3D}}
        b_ms, b_by = bound(r)
        per_frame = max(launches["2d"][name] // len(CASES),
                        launches["3d"][name] // n3)
        if name in KERNELS_V1:
            per_frame = launches["v1"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": per_frame,
            "launches_2d_path": launches["2d"][name],
            "launches_3d_path": launches["3d"][name],
            "launches_cli": launches["cli"][name],
            "launches_viewer": {k: v[name]
                                for k, v in launches["viewer"].items()
                                if v.get(name)},
            "max_abs_err": max(errs + [x["max_abs_err"] for x in flat_3d]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "at": at, **extra,
        })
    rows.extend(results["unrolled"])
    rows.extend(results["fit_rows"])
    k2f = next(r for r in rows if r["name"] == "scan_eval")
    k2f["per_launch"] = results["k2f"]
    k2f["launches_brute"] = {k: r["launches"]
                             for k, r in results["k2f"].items()}
    launch_rows = list(results["k2f"].items())
    for c, x in k2f["per_fit"].items():
        launch_rows += [(f"{c} fit", x),
                        (f"{c} fit, not storing", x["plain_walk"])]
    slower = [k for k, r in launch_rows if r.get("vs_first") is None
              or r["vs_first"] > 1.0]
    verdict = (f"MISSED at {slower}" if slower
               else "no launch slower: held")
    print(f"K2f against its first design in this run: "
          f"{ {k: r.get('vs_first') for k, r in launch_rows} }; {verdict}"
          f"  [{card}]")
    print(json.dumps({"fits": results["fits"], "mesh": results["mesh"]}))
    print(json.dumps({"native": results["native"],
                      "viewer": results["viewer"], "card": card}))
    print(json.dumps({"effects": effect_rows}))
    sweeps = {f"stress_2d({nb}) {sz}^2": results[sz]["sweep"]
              for nb, sz in CASES}
    sweeps.update({c: results[c]["sweep"] for c, *_ in CASES_3D})
    sweeps["kernel phase"] = results["v1_sweep"]
    print(json.dumps({"launch_sweep": sweeps}))
    print(json.dumps({"unrolled_options": results["unrolled_options"],
                      "card": card}))
    print(json.dumps({"unrolled_sweep": results["unrolled_sweep"],
                      "unrolled_against_first_design":
                          results["unrolled_vs_first_design"]}))
    print(json.dumps({"previous_design_ms": PREVIOUS_DESIGN_MS,
                      "measured_in_this_run": False,
                      "recorded_on": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# phase 13's and 14's build threads, joined on the way out so that no nvcc
# process outlives the script
_PRE = {}


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    finally:
        for box in ("box", "box14"):
            if box in _PRE:
                _PRE[box]["thread"].join()
