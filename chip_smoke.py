"""Smoke run of ceres_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from the sources, holds each kernel against its plain PyTorch version at
the real inputs of BAL-16, of the Venice shape (13,696 cameras, 1M points,
~4.4M observations) and of the libmv bundle adjuster's model on both
geometries, drives the public `solve()` on every path the port runs (the
jt path: BAL-16 DENSE_SCHUR and ITERATIVE_SCHUR in float64 and float32,
the Venice shape with ITERATIVE_SCHUR in both, a 2,048-camera
Venice-shaped instance on the card against the same solve on the CPU; the
flat path: libmv16 DENSE_SCHUR and ITERATIVE_SCHUR in both dtypes against
the JAX package's answer, libmv16 on the card against the CPU, and
libmv-Venice with ITERATIVE_SCHUR in both), drives the specialized BAL-16
pipeline of parallel/sharded_ba.py (lm_step_schur_k and lm_step_schur_v2_k,
k = 20, both dtypes, against the JAX package's costs, with no host sync
inside a call, and on the card against the CPU), drives robust-loss and
quaternion-camera BA through eval_fused's loss and manifold branches
(BAL-16 with HuberLoss(1.0), angle-axis and quaternion cameras, against
the JAX package's answers; the quaternion Venice shape with HuberLoss(1.0);
every loss in both camera models against the plain version), counts what
each run launched, and times the kernels (segment_block_expand at each
width a libmv solve gathers, 3, 6, 8 and 9, beside torch.index_select;
segment_block_sum and unsorted_segment_sum at the widths a flat CG
iteration sums, 3, 8 and 6, beside Tensor.index_add; each call's own peak
device memory; schur_assembly also at 120 cameras; 8J's slab pass apart
from its F'F passes; the device kernels of each eval_fused and spread call,
and eval_fused's registers and occupancy in each variant), holds
schur_assembly's AtA and schur_jacobi_blocks' and 8J's F'F blocks to exact
symmetry and a repeated call of each, of both segment sums, both spread
sums and eval_fused to the same bits, the
solves (with the device time
per LM iteration of isc_matvec, normal_matvec, post_eval_fused,
schur_jacobi_blocks and schur_assembly, pass by pass, at BAL-16
DENSE_SCHUR and ITERATIVE_SCHUR and at the Venice shape in both dtypes,
and of segment_block_sum and unsorted_segment_sum at libmv16 and
libmv-Venice;
and the CG iterations of float32 BAL-16 +
HuberLoss(1.0) ITERATIVE_SCHUR beside those of the same solve through
isc_matvec's plain version on the card and on the CPU and the JAX
package's, with the symmetry of the Schur operator where the kernel path's
count first parts from the plain version's) and the pipeline. It also
drives the solvers of port slice 11: CGNR with JACOBI on BAL-16 in both
dtypes against the JAX package's answers (scripts/cgnr16_golden.py), its
matvec through normal_matvec (held against its plain version and timed at
the first CG iteration's inputs), on the card against the CPU, and at the
Venice shape in float32; CGNR on libmv16 through the flat chain, card
against CPU; DENSE_SCHUR with TRADITIONAL and SUBSPACE dogleg on BAL-16
against the JAX package's answers (scripts/dogleg16_golden.py); and the
More-Garbow-Hillstrom corpus with DENSE_QR and DENSE_NORMAL_CHOLESKY on
the card (17 of 19), against the same solves on the CPU. And the paths of
the modeling API (modeling_phase), against the JAX
package's answers (scripts/modeling16_golden.py): gauge-fixed BAL-16 built
one block at a time (a constant camera, the row plan's sentinel, through
rows 1-4b), box-bounded BAL-16, evaluation_dtype="mixed", mixed-precision
solves, libmv16 with constant intrinsics, a user ordering, and the nine
constrained MGH problems; with rows 1-4b, 6, 7 and 9 held against their
plain versions and timed at the sentinel inputs.

    python3 chip_smoke.py

Exits nonzero on any failure, and before printing any result when no CUDA
device is available. Its last line is {"ok": true, "device": {...}}; the
line before it lists every ported TPU kernel with its launches, error and
times. Imports nothing of jax and nothing of ceres_tpu.
"""
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bench_golden.json, "bal16_dense_schur_f64": BAL-16 DENSE_SCHUR in float64
GOLDEN_COST = 51931.10068031216
GOLDEN_ROWS = 17
# scripts/libmv16_golden.py: the JAX package's libmv16 DENSE_SCHUR solve in
# float64 (its ITERATIVE_SCHUR + SCHUR_JACOBI solve: 51910.1670875214, 31 rows)
LIBMV16_GOLDEN_COST = 51910.428095046474
LIBMV16_GOLDEN_ROWS = 22
# ITERATIVE_SCHUR card against CPU on libmv16 holds the first 20 LM
# iterations: in its last ten, costs move by ~1e-7 per row, and which CG
# count (15 or 17) a row's eta-forced CG takes changes with the rounding
# of the sums (card, CPU and a one-ulp CPU twin each took another set).
# Cut in depth to 10, and the DENSE_SCHUR one (22 rows, to convergence)
# to 10 too, to keep the run within time beside the host loop's phase:
# at the full depths their two CPU solves each took 66 and 76 s on the
# chip machine's host
LIBMV16_CARD_VS_CPU_ITERATIONS = 10
# scripts/specialized16_golden.py: the JAX package's lm_step_schur_k on
# BAL-16 (rows sorted by point, radius 1e4) in float64, the cost after 5,
# 10, 15 and 20 LM iterations
SPECIALIZED16_GOLDEN = (53008.80829035682, 51931.09314041564, 51931.09254649271,
                        51931.09250709464)
# the same in float32 with the default flags: it stalls from iteration 5 on
SPECIALIZED16_JAX_F32 = 52991.1328125
# scripts/robust16_golden.py: the JAX package's BAL-16 solves with
# HuberLoss(1.0) in float64, (final cost, summary rows): angle-axis and
# quaternion cameras, DENSE_SCHUR (CONVERGENCE) and ITERATIVE_SCHUR +
# SCHUR_JACOBI with max_num_iterations=30, max_linear_solver_iterations=100
# (NO_CONVERGENCE after 30)
ROBUST16_GOLDEN = {
    ("bal16_huber", "dense"): (43747.3819648076, 32),
    ("bal16_huber", "iterative"): (43747.93153876991, 31),
    ("bal16_quat_huber", "dense"): (43747.38311038638, 32),
    ("bal16_quat_huber", "iterative"): (43747.931607040824, 31),
}
# float32 robust solves: the JAX package's own trajectory bound for Huber
# (tests/test_fused_lm.py:462-464): robust systems are near-singular along
# outlier directions, so equally good float32 steps part
ROBUST_F32_REL = 5e-3
# scripts/cgnr16_golden.py: the JAX package's BAL-16 CGNR + JACOBI solves
# with the default options (CONVERGENCE, 28 rows), final cost in float64
# and float32
CGNR16_GOLDEN = {"float64": 51931.26916069753, "float32": 51931.2734375}
# the BAL-16 and libmv16 CGNR solves of card against CPU, cut in depth: the
# CPU solves of libmv16 take 1-2 s an LM iteration on the card's host
CGNR16_CARD_VS_CPU_ITERATIONS = 15
LIBMV16_CGNR_CARD_VS_CPU_ITERATIONS = 10
# scripts/dogleg16_golden.py: the JAX package's BAL-16 DENSE_SCHUR solves
# with DOGLEG in float64 (CONVERGENCE, 17 rows each; from the default radius
# of 1e4 every step is the Gauss-Newton point, so the two agree)
DOGLEG16_GOLDEN = {"TRADITIONAL_DOGLEG": 52121.22854470117,
                   "SUBSPACE_DOGLEG": 52121.22854470117}
# scripts/modeling16_golden.py: the JAX package's answers on the paths of
# the modeling phase, (final cost, summary rows), on the CPU with the fused
# loop: (a) BAL-16 built one block at a time, camera 0 constant; (b)
# BAL-16 with a box on the points, per coordinate the 5th to 95th
# percentile of the start (BOX_PERCENTILES), float32 run to convergence
# (BOX_F32_TO_CONVERGENCE, the golden's "_converged" line); (c)
# evaluation_dtype="mixed";
# (d) use_mixed_precision_solves; (e) libmv16 with constant intrinsics;
# (f) the user ordering [[points], [cameras]]. Its float32 solves are held
# to their own answers; its mixed schedule's rows hold the shared iterate
# twice (the port's once)
MODELING16_GOLDEN = {
    "bal16_gauge_dense_f64": (51931.99114668563, 22),
    "bal16_gauge_dense_f32": (51932.0, 23),
    "bal16_gauge_iterative_f64": (52312.799713299595, 14),
    "bal16_gauge_iterative_f32": (52312.66015625, 49),
    "bal16_bounds_dense_f64": (52026.880074942426, 32),
    "bal16_bounds_dense_f32": (51931.51171875, 70),
    "bal16_mixed_dense": (51931.100523447356, 19),
    "bal16_mixed_iterative": (51931.14477628934, 26),
    "bal16_mixed_solves_dense_f64": (51931.10068292243, 17),
    "libmv16_const_intrinsics_dense_f64": (51911.15182028923, 19),
    "libmv16_const_intrinsics_iterative_f64": (51911.257333382135, 22),
    "bal16_ordering_dense_f64": (51931.10068031216, 17),
}
# the coordinates of the box-bounded answer on a bound in the JAX package's
# float64 and float32 solves (141 and 160 of 66,318: under 1%); the float64
# count is gated, the float32 one only logged: which coordinates a float32
# solve leaves exactly on a bound follows its rounding
BOUNDS16_ON_BOUND = {"float64": 141, "float32": 160}
BOX_PERCENTILES = (5.0, 95.0)
# the float32 box-bounded solve runs to convergence: with the default
# options it stops on the function tolerance while its cost still falls by
# ~1e-6 a row, at a place that follows float32 rounding (the port's and the
# JAX package's part by 6.5e-5 there, scripts/bounds16_f32_witness.py)
BOX_F32_TO_CONVERGENCE = dict(function_tolerance=1e-12, max_num_iterations=200)
# the JAX package's 2 * final cost of each constrained MGH problem (all
# nine solved by the reference's 4-digit criterion), per dense solver
MGH_CONSTRAINED_GOLDEN = {
    "DENSE_QR": {3: 1.5125936724383832e-10, 4: 783.999999295184, 5: 0.0,
                 7: 0.9904221209613995, 9: 1.127932769618641e-08,
                 12: 3.099815343228943e-06, 14: 1.5567008004385652,
                 16: 88860.47976750063, 18: 0.0005320986590782367},
    "DENSE_NORMAL_CHOLESKY": {3: 1.5125936724383832e-10, 4: 783.999999295184, 5: 0.0,
                              7: 0.9904221209613995, 9: 1.127932769618641e-08,
                              12: 3.0998153432288427e-06, 14: 1.5567008004385652,
                              16: 88860.4797675009, 18: 0.0005320986590782369},
    "DENSE_NORMAL_CHOLESKY_mixed": {3: 1.5125936724382232e-10, 4: 783.999999295184,
                                    5: 0.0, 7: 0.9904221209613995,
                                    9: 1.127932769618641e-08,
                                    12: 3.0998153432290727e-06,
                                    14: 1.5567008004385652, 16: 88860.47976750093,
                                    18: 0.0005320986590782357},
}
# the card against the CPU on the modeling paths, cut in depth: a BAL-16
# DENSE_SCHUR LM iteration takes seconds on the card's host
MODELING_CARD_VS_CPU_ITERATIONS = 4
# the MGH problems that miss the optimum at trial 0, in both packages: #2
# stops at the local minimum 48.98, #16 crawls (tests/test_mgh.py:10-17);
# the JAX host loop misses the same two (scripts/hostloop16_golden.py d)
MGH_MISSES = (2, 16)
# scripts/hostloop16_golden.py: the JAX package's answers in its host loop,
# (final cost, summary rows): (a) BAL-16 with fused_loop="NEVER"; (b)
# DENSE_SCHUR ended by an IterationCallback at iteration 5
# (SOLVER_TERMINATE_SUCCESSFULLY) or 2 (SOLVER_ABORT), with the message and
# the EvaluationCallback's calls; (c) both doglegs over ITERATIVE_SCHUR +
# SCHUR_JACOBI, the host minimizer built directly (Options.is_valid refuses
# DOGLEG with an iterative solver in solve())
HOSTLOOP16_GOLDEN = {
    "bal16_host_dense_f64": (51931.10068031216, 17),
    "bal16_host_dense_f32": (51931.09765625, 17),
    "bal16_host_iterative_f64": (51931.87165466737, 22),
    "bal16_host_iterative_f32": (51931.8671875, 22),
    "bal16_host_cgnr_f64": (51931.26916069755, 28),
    "SOLVER_TERMINATE_SUCCESSFULLY": (53178.934259091, 6,
                                      "User callback returned SOLVER_TERMINATE_SUCCESSFULLY.", 6),
    "SOLVER_ABORT": (136880.59071100914, 3, "User callback returned SOLVER_ABORT.", 3),
    "TRADITIONAL_DOGLEG": (52121.23658046776, 13),
    "SUBSPACE_DOGLEG": (52121.236580486424, 13),
}
# scripts/hostloop16_golden.py e: the JAX package's answers of the manifold
# problems (MANIFOLD_CASES), DENSE_QR in its host loop: (final cost, rows,
# the fitted parameter block)
MANIFOLD_GOLDEN = {
    "sphere": (0.3653879802463018, 5, [0.3260538140694403, 0.6722576243136242,
                                       0.6646492284528529]),
    "line": (0.07982665520986526, 6, [0.8308394399919016, -1.3391148147218426,
                                      0.005734038955158617, 0.2729446216299968,
                                      0.5313476073561008, 0.8019793972916043]),
    "quaternion": (0.0036312781394010904, 5, [0.8993325444807283, 0.19954131974811498,
                                              -0.2989028583036928, 0.24908094557569405]),
}
# the host loop's card-against-CPU solves, cut in depth as the fused ones
HOST_CARD_VS_CPU_ITERATIONS = 15
# the Venice shape in the host loop: LM iterations of each solve
HOST_VENICE_LM_ITERATIONS = 3
# the kernels of the host loop's block steps (solvers/bsr_kernels.py): the
# flat products gather by row 7 and sum by 6 (point ids) and 9 (camera
# ids); DENSE_SCHUR also sums the blocks of W and F'F by 6
HOST_PATH = ("segment_block_sum", "segment_block_expand", "unsorted_segment_sum")
SPECIALIZED_K = 20  # LM iterations per call, as bench.py:147
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# peak rate of each type (NVIDIA H100 SXM data sheet, dense): float32
# outside the tensor cores, float64 on them (FP64 tensor-core DMMA)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
REL_LIMIT = {torch.float64: 1e-11, torch.float32: 1e-4}
TAG = {"float64": "f64", "float32": "f32"}
# bench.py:308-311 (bench_large_c, the JAX package's BASELINE config 4)
VENICE = dict(num_cameras=13696, num_points=1_000_000, mean_track=4.4,
              cam_window=60, seed=0)
VENICE_PERTURB = dict(rotation_sigma=0.01, translation_sigma=0.1,
                      point_sigma=0.1, seed=1)
VENICE_LM_ITERATIONS = 5
# past the JAX package's 1024-camera window threshold, small for the CPU
SMALL_VENICE = dict(VENICE, num_cameras=2048, num_points=30_000)
# schur_assembly at 120 cameras (tests/test_torch_cuda.py): an AtA of
# 1080 x 1080, past the JAX package's t_full = 1024 for this path
C120 = dict(num_cameras=120, num_points=2000, visibility=0.04, seed=6)
SMALL_VENICE_LM_ITERATIONS = 5

# one row per TPU kernel: (row, wrapper, source, replaces)
ROWS = [
    ("1", "eval_fused", "eval_fused", "ceres_tpu/ops/pallas_kernels.py:2066"),
    ("1L", "eval_fused_loss", "eval_fused",
     "ceres_tpu/ops/pallas_kernels.py:2066 (loss_rho branch :2356-2402)"),
    ("1Q", "eval_fused_quat", "eval_fused",
     "ceres_tpu/ops/pallas_kernels.py:2066 (pj_cols branch :2323-2347, "
     "rows_fn snavely_quat_residual_rows)"),
    ("2", "post_eval_fused", "post_eval_fused",
     "ceres_tpu/ops/pallas_kernels.py:1780"),
    ("3", "schur_assembly", "schur_assembly",
     "ceres_tpu/ops/pallas_kernels.py:1281 (mode=dense)"),
    ("3b", "schur_jacobi_blocks", "schur_jacobi",
     "ceres_tpu/ops/pallas_kernels.py:1281 (mode=schur_jacobi)"),
    ("4", "normal_matvec", "normal_matvec",
     "ceres_tpu/ops/pallas_kernels.py:781 (mode=normal, via normal_matvec :1759)"),
    ("4b", "isc_matvec", "isc_matvec",
     "ceres_tpu/ops/pallas_kernels.py:781 (mode=isc, via isc_matvec :1716)"),
    ("5", "schur_jacobi_blocks", "schur_jacobi",
     "ceres_tpu/ops/pallas_kernels.py:2682 (sj_assembly_windowed)"),
    ("6", "segment_block_sum", "segment_sum",
     "ceres_tpu/ops/pallas_kernels.py:228 (and jt_u_sorted :2513)"),
    ("7", "segment_block_expand", "segment_expand",
     "ceres_tpu/ops/pallas_kernels.py:354"),
    ("8", "segment_spread_sum", "segment_spread",
     "ceres_tpu/ops/pallas_kernels.py:462 (without Jc)"),
    ("8J", "segment_spread_ftf", "segment_spread",
     "ceres_tpu/ops/pallas_kernels.py:462 (with Jc, pallas_call :734)"),
    ("9", "unsorted_segment_sum", "segment_sum",
     "ceres_tpu/ops/pallas_kernels.py:2563 (windowed_segment_sum)"),
]
# the shape of each row's main numbers, and the path its launches come from
ROW_SHAPE = {"1": "bal16", "1L": "bal16", "1Q": "bal16", "2": "bal16", "3": "bal16",
             "3b": "bal16", "4": "bal16", "4b": "bal16", "5": "venice", "6": "libmv16",
             "7": "libmv16", "8": "libmv16", "8J": "bal16_specialized",
             "9": "libmv16"}
ROW_PATH = {"1": "bal16_dense_f64", "1L": "bal16_huber_dense_f64",
            "1Q": "bal16_quat_huber_dense_f64", "2": "bal16_dense_f64",
            "3": "bal16_dense_f64", "4": "bal16_dense_f64",
            "3b": "bal16_iterative_f64", "4b": "bal16_iterative_f64",
            "5": "venice_iterative_f32", "6": "libmv16_dense_f64",
            "7": "libmv16_dense_f64", "8": "libmv16_dense_f64",
            "8J": "specialized_v1_f64", "9": "libmv16_dense_f64"}
# a row's other shapes, and its further cases (case, key suffix[, their
# own shapes])
ROW_VARIANTS = {"1": ["venice", "bal16_gauge"], "1L": ["venice"], "1Q": ["venice"],
                "2": ["venice", "bal16_gauge"], "3": ["c120", "bal16_gauge"],
                "3b": ["bal16_gauge"], "4": ["venice", "bal16_gauge"],
                "4b": ["venice", "bal16_gauge"], "6": ["libmv_venice"],
                "7": ["libmv_venice"], "9": ["libmv_venice"]}
# (rows 6 and 9 also at the widths each CG iteration of the flat
# ITERATIVE_SCHUR step sums: w = 3 over the points, w = 8 over libmv's one
# intrinsics key, w = 6 over the cameras)
# (row 4 also at the inputs of BAL-16 CGNR's first CG iteration)
# (rows 1, 2, 3, 3b, 4 and 4b also at gauge-fixed BAL-16's, camera 0
# constant: the row plan's sentinel; rows 6, 7 and 9 at its camera slot's
# flat plan, whose sentinel key takes camera 0's rows)
ROW_CASES = {"4": [("normal_matvec_cgnr", "_cgnr", ["bal16"])],
             "6": [("segment_block_sum_one_key", "_one_key"),
                   ("segment_block_sum_w3", "_w3"),
                   ("segment_block_sum_one_key_w8", "_one_key_w8"),
                   ("segment_block_sum_sentinel", "_sentinel", ["bal16_gauge"])],
             "7": [(f"segment_block_expand_t{t}", f"_t{t}") for t in (3, 8, 9)]
             + [("segment_block_expand_sentinel", "_sentinel", ["bal16_gauge"])],
             "9": [("unsorted_segment_sum_w6", "_w6"),
                   ("unsorted_segment_sum_sentinel", "_sentinel", ["bal16_gauge"])]}
# why no single PyTorch call computes each kernel's function
NO_LIBRARY_CALL = {
    "eval_fused": "no PyTorch call evaluates a residual and its Jacobian",
    "eval_fused_loss": "no PyTorch call evaluates a residual and its Jacobian",
    "eval_fused_quat": "no PyTorch call evaluates a residual and its Jacobian",
    "post_eval_fused": "five reductions (g, column norms, E'E) in one pass",
    "schur_assembly": "no call forms the Schur complement of a block-sparse J",
    "normal_matvec": "(J'J)x of a sparse J needs two products, J x then J'(Jx)",
    "isc_matvec": "no call forms S z of a block-sparse J (two sparse products "
                  "and a per-point 3x3 solve between them)",
    "schur_jacobi_blocks": "no call forms block-diag(S) of a block-sparse J",
    "segment_spread_ftf": "no call forms the dense-Schur A and the camera Gram "
                          "blocks F'F together (index_put forms A alone)",
}
DENSE_PATH = ("eval_fused", "post_eval_fused", "schur_assembly", "normal_matvec")
ITERATIVE_PATH = ("eval_fused", "post_eval_fused", "normal_matvec", "isc_matvec",
                  "schur_jacobi_blocks")
FLAT_DENSE_PATH = ("segment_block_sum", "segment_block_expand", "segment_spread_sum",
                   "unsorted_segment_sum")
FLAT_ITERATIVE_PATH = ("segment_block_sum", "segment_block_expand",
                       "unsorted_segment_sum")
# CGNR on a BAL program: the flat evaluation's post-evaluation sums (6, 9),
# the gather of J x (7) and the matvec (4); on any other program the flat
# chain alone (FLAT_ITERATIVE_PATH); DENSE_QR and DENSE_NORMAL_CHOLESKY run
# no kernel (torch.linalg on the dense Jacobian, as the JAX package's)
CGNR_PATH = ("normal_matvec",) + FLAT_ITERATIVE_PATH
# the kernel calls of the specialized pipeline, in the order of a k-call's
# first iteration, each with its launches in a k-call, a * k + b: v1 gathers
# the points at each of its k + 1 evaluations (7), sums the point rows (6),
# gathers [K | sp] to the rows (7) and spreads A with F'F (8J) once an
# iteration; v2 gathers at each evaluation (7), sums [E'r | diag | E'E]
# (6), assembles (3) and sums E_s'F_s z (6) once an iteration; every other
# kernel launches no time. Each case is checked and timed at the inputs the
# first iteration gives it (v2's point gather is v1's: the same points).
SPECIALIZED_CASES = {
    "v1": (("segment_block_expand_pts", 1, 1), ("segment_block_sum_v1", 1, 0),
           ("segment_block_expand_v1", 1, 0), ("segment_spread_ftf", 1, 0)),
    "v2": (("segment_block_expand_pts", 1, 1), ("segment_block_sum_v2", 1, 0),
           ("schur_assembly_v2", 1, 0), ("segment_block_sum_v2_etfz", 1, 0)),
}
# the variants of eval_fused, each counted on its own wrapper: the
# angle-axis model without a loss (row 1), with one (1L), the quaternion
# model with or without (1Q)
EVAL_VARIANTS = ("eval_fused", "eval_fused_loss", "eval_fused_quat")
# the losses the robust phase holds eval_fused to its plain version with:
# the nine of ceres_tpu_torch.loss, Composed and Scaled as in
# tests/test_loss.py:23-31, parameters past which BAL-16's residuals reach
ROBUST_LOSSES = {
    "trivial": lambda ctt: None,
    "huber": lambda ctt: ctt.HuberLoss(1.0),
    "soft_l_one": lambda ctt: ctt.SoftLOneLoss(0.7),
    "cauchy": lambda ctt: ctt.CauchyLoss(1.3),
    "arctan": lambda ctt: ctt.ArctanLoss(1.3),
    "tolerant": lambda ctt: ctt.TolerantLoss(0.7, 0.4),
    "tukey": lambda ctt: ctt.TukeyLoss(2.0),
    "scaled": lambda ctt: ctt.ScaledLoss(ctt.CauchyLoss(1.0), 3.0),
    "composed": lambda ctt: ctt.ComposedLoss(ctt.HuberLoss(1.1), ctt.SoftLOneLoss(0.5)),
}
# the kernels whose device kernels a call launches are logged, with their
# device times (eval_fused's variants must launch one)
PASSES_LOGGED = EVAL_VARIANTS + ("segment_spread_sum", "segment_spread_ftf")
# the kernels a repeated call of must give the same bits (no atomics: fixed
# orders; eval_fused's count of finished blocks set back by its last block),
# and those whose 9 x 9 output blocks must be exactly symmetric
REPEAT_GATED = ("schur_assembly", "schur_jacobi_blocks", "segment_block_sum",
                "unsorted_segment_sum", "segment_spread_sum", "segment_spread_ftf",
                *EVAL_VARIANTS)
EXACTLY_SYMMETRIC = ("schur_assembly", "schur_jacobi_blocks", "segment_spread_ftf")
# the kernel checks: case -> wrapper
CASES = {"eval_fused": "eval_fused", "post_eval_fused": "post_eval_fused",
         "eval_fused_loss": "eval_fused_loss", "eval_fused_quat": "eval_fused_quat",
         "schur_assembly": "schur_assembly", "normal_matvec": "normal_matvec",
         "normal_matvec_cgnr": "normal_matvec",
         "isc_matvec": "isc_matvec", "isc_matvec_no_u": "isc_matvec",
         "schur_jacobi_blocks": "schur_jacobi_blocks",
         "segment_block_sum": "segment_block_sum",
         "segment_block_sum_one_key": "segment_block_sum",
         "segment_block_sum_w3": "segment_block_sum",
         "segment_block_sum_one_key_w8": "segment_block_sum",
         "unsorted_segment_sum": "unsorted_segment_sum",
         "unsorted_segment_sum_w6": "unsorted_segment_sum",
         "unsorted_segment_sum_sentinel": "unsorted_segment_sum",
         "segment_block_sum_sentinel": "segment_block_sum",
         "segment_block_expand_sentinel": "segment_block_expand",
         "segment_block_expand": "segment_block_expand",
         **{f"segment_block_expand_t{t}": "segment_block_expand" for t in (3, 8, 9)},
         "segment_spread_sum": "segment_spread_sum",
         "segment_spread_ftf": "segment_spread_ftf",
         "segment_block_expand_pts": "segment_block_expand",
         "segment_block_sum_v1": "segment_block_sum",
         "segment_block_expand_v1": "segment_block_expand",
         "segment_block_sum_v2": "segment_block_sum",
         "schur_assembly_v2": "schur_assembly",
         "segment_block_sum_v2_etfz": "segment_block_sum",
         **{f"eval_fused_{model}_{loss}": "eval_fused"
            for model in ("angle_axis", "quat") for loss in ROBUST_LOSSES}}


def exactly_symmetric(name, out):
    """schur_assembly's AtA and FtF blocks, schur_jacobi_blocks' blocks or
    segment_spread_ftf's F'F blocks, equal to their transposes bit for bit."""
    if name == "schur_assembly":
        ata, ftf = out[0], out[1].reshape(-1, 9, 9)
        return torch.equal(ata, ata.T) and torch.equal(ftf, ftf.transpose(1, 2))
    blocks = (out[1] if name == "segment_spread_ftf" else out).reshape(-1, 9, 9)
    return torch.equal(blocks, blocks.transpose(1, 2))


def specialized_launches(pipeline, k):
    """The exact launches of each wrapper in one k-call."""
    want = {}
    for case, a, b in SPECIALIZED_CASES[pipeline]:
        want[CASES[case]] = want.get(CASES[case], 0) + a * k + b
    return want


def libmv_instance(truth, start, seed=1):
    """The libmv bundle adjuster's model (ceres_tpu_torch.models.libmv) on
    a BAL geometry: cameras truth.cameras[:, :6] (angle-axis, t), one
    shared intrinsics block [mean focal, 0, ...], markers the libmv
    projection of the true cameras and points in float64 plus N(0, 1)
    noise from default_rng(seed); the solve starts from start's cameras
    and points. Returns a LibmvProblem of image-space markers."""
    from ceres_tpu_torch.models import libmv

    intr = np.zeros(libmv.INTRINSICS_SIZE)
    intr[0] = truth.cameras[:, 6].mean()
    cams = truth.cameras[:, :6]
    it = torch.as_tensor(intr)
    zero = torch.zeros(2, dtype=torch.float64)
    project = torch.func.vmap(
        lambda c, p: libmv.libmv_reprojection_residual(c, p, it, zero))
    B = truth.num_observations
    markers = np.empty((B, 2))
    for a in range(0, B, 1 << 20):
        rows = slice(a, min(a + (1 << 20), B))
        markers[rows] = project(torch.as_tensor(cams[truth.camera_index[rows]]),
                                torch.as_tensor(truth.points[truth.point_index[rows]])).numpy()
    markers += np.random.default_rng(seed).standard_normal((B, 2))
    return libmv.LibmvProblem(
        is_image_space=True, intrinsics=intr, cameras=start.cameras[:, :6].copy(),
        camera_images=np.arange(truth.num_cameras), points=start.points.copy(),
        point_tracks=np.arange(truth.num_points),
        marker_cam=truth.camera_index.astype(np.int64),
        marker_pt=truth.point_index.astype(np.int64), markers=markers)


def libmv16():
    """libmv16: the BAL-16 geometry (bench.py:119-127) as a libmv problem:
    16 cameras, 22,106 points, 84,218 markers."""
    from ceres_tpu_torch.models import bal

    b = bal.synthetic_bal(num_cameras=16, num_points=22106,
                          visibility=83718 / (16 * 22106), noise=1.0, seed=0)
    return libmv_instance(b, bal.perturb(b, 0.02, 0.2, 0.2, seed=1))


def libmv_venice():
    """libmv-Venice: the Venice shape as a libmv problem: 13,696 cameras,
    1M points, 4,397,236 markers, one shared camera model."""
    from ceres_tpu_torch.models import bal

    b = bal.synthetic_bal_large(**VENICE)
    return libmv_instance(b, bal.perturb(b, **VENICE_PERTURB))


def gauge_fixed_problem(bal, b, constant=(0,)):
    """Path (a) of the modeling phase: the BAL arrays of b (copied: a solve
    writes into them) built one block at a time (bal.build_problem), the
    cameras numbered in `constant` held constant (the gauge). Returns
    (problem, camera blocks, point blocks)."""
    p, cams, pts = bal.build_problem(bal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    for c in constant:
        p.set_parameter_block_constant(cams[c])
    return p, cams, pts


def sentinel_cases(dtype, device, constant=(0,), num_cameras=6, num_points=120):
    """Each kernel's arguments at a small gauge-fixed BAL problem built one
    block at a time (gauge_fixed_problem, the cameras in `constant` held
    constant): rows 1, 2, 3, 3b, 4 and 4b at its row plan, whose sentinel
    (camera ids C and above) holds those cameras' rows, with random
    camera and point operands; rows 6, 7 and 9 at its camera slot's flat
    plan, whose sentinel key C takes them (9 over the rows as they lie, 6
    over them sorted by camera, 7 gathering a table with its zero last
    row). tests/test_torch_kernels_emulated.py, tests/test_torch_cuda.py
    and scripts/sentinel_asan.py run them."""
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import kernels as kn
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps, FlatDenseSchurStepOps
    import ceres_tpu_torch as ctt

    b = bal.perturb(bal.synthetic_bal(num_cameras=num_cameras, num_points=num_points,
                                      visibility=0.5, seed=4), 0.01, 0.05, 0.05, seed=1)
    prog = CompiledProgram(gauge_fixed_problem(bal, b, constant)[0], dtype, device=device)
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ops = DenseSchurStepOps(prog, opts, [1])
    plan, q, dt = ops.flat.plan, ops._jt_qual, prog.compute_dtype
    x = prog.initial_state()
    cams = prog.family_table(x, q.fam_f).to(dt).contiguous()
    pts = prog.family_table(x, q.fam_e).to(dt).contiguous()
    _, rT, JT = kn.eval_fused_plain(cams, pts, prog.kinds[0].data, plan, q.rows_fn)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.as_tensor(rng.uniform(0.5, 1.5, shape)).to(device, dt)

    P, C = plan.P, plan.C
    A = rand(P, 3, 3)
    minv = (A @ A.transpose(1, 2)).reshape(P, 9).contiguous()
    pcam = FlatDenseSchurStepOps(prog, opts, [1]).flat.plans_f[0][0]
    local = pcam.local.cpu().numpy()
    order = np.argsort(local, kind="stable")
    rows = torch.as_tensor(rng.standard_normal((local.shape[0], 99))).to(device, dt)
    return {
        "eval_fused": (cams, pts, prog.kinds[0].data, plan, q.rows_fn),
        "post_eval_fused": (JT, rT, plan),
        "schur_assembly": (JT, rand(C, 9), rand(P, 3),
                           torch.tril(rand(P, 3, 3)).reshape(P, 9).contiguous(),
                           rand(P, 3), plan),
        "normal_matvec": (JT, rand(C, 9), rand(P, 3), plan),
        "isc_matvec": (JT, rand(C, 9), minv, plan, True),
        "schur_jacobi_blocks": (JT, rand(P, 3), minv, plan),
        "unsorted_segment_sum": (rows, pcam.seg),
        "segment_block_sum": (rows[torch.as_tensor(order, device=rows.device)].contiguous(),
                              fo.build_segment_plan(local[order], pcam.nv + 1, device)),
        "segment_block_expand": (torch.cat([rand(C, 9), torch.zeros((1, 9), dtype=dt,
                                                                    device=device)]),
                                 pcam.local),
    }


def fresh(lp):
    """A copy of a LibmvProblem whose arrays a solve may write into."""
    import dataclasses

    return dataclasses.replace(lp, cameras=lp.cameras.copy(), points=lp.points.copy(),
                               intrinsics=lp.intrinsics.copy())


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0].strip()


def time_cuda(fn, n):
    """Milliseconds per call on the device: warm up, keep the card busy with
    a sleep kernel while the host enqueues n calls, then time the n calls
    between CUDA events, so that host dispatch is not in the figure."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(n * host_s * 1.5 + 2e-3, 2.0)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def rel_err(ref, out):
    """max over outputs of max|out - ref| / max|ref|, max|out - ref|, and
    each output's max|out - ref| / max|ref|."""
    rels, mabs = [], 0.0
    for a, b in zip(as_tuple(ref), as_tuple(out)):
        if a is None:
            check(b is None, "an output the plain version leaves out came back")
            continue
        check(a.shape == b.shape, f"shape {tuple(b.shape)} != {tuple(a.shape)}")
        err = (a.double() - b.double()).abs().max().item()
        scale = a.double().abs().max().item()
        check(np.isfinite(err), "non-finite kernel output")
        rels.append(err / max(scale, 1e-300))
        mabs = max(mabs, err)
    return max(rels), mabs, rels


def upcast(args):
    """The arguments with every float32 tensor in float64."""
    return tuple(a.double() if isinstance(a, torch.Tensor) and a.dtype == torch.float32
                 else a for a in args)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def counts(kn):
    return ({k.__name__: k.launches for k in kn.KERNELS},
            {k.__name__: k.plain_calls for k in kn.KERNELS})


def first_iteration_args(pipeline, run, start):
    """{case: arguments} of the kernel calls of the pipeline's first
    iteration (SPECIALIZED_CASES), caught from a call of one iteration
    in which each wrapper is replaced by a recorder that answers
    through the plain version. `run(state, k)` makes a k-call."""
    from ceres_tpu_torch.ops import kernels as kn

    cases = SPECIALIZED_CASES[pipeline]
    names = {CASES[c] for c, _, _ in cases}
    saved = {n: getattr(kn, n) for n in names}
    seen = []

    def recorder(name):
        def call(*args):
            seen.append((name, args))
            return getattr(kn, name + "_plain")(*args)
        return call

    try:
        for n in names:
            setattr(kn, n, recorder(n))
        run(start, 1)
    finally:
        for n, fn in saved.items():
            setattr(kn, n, fn)
    check([n for n, _ in seen[:len(cases)]] == [CASES[c] for c, _, _ in cases],
          f"{pipeline}: first iteration's kernel calls "
          f"{[n for n, _ in seen]}, expected {[c for c, _, _ in cases]} first")
    return {c: args for (c, _, _), (_, args) in zip(cases, seen)}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal, libmv
    from ceres_tpu_torch.ops import build
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import kernels as kn
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solver import _pick_linear_solver
    from ceres_tpu_torch.solvers.fused_lm import (
        DenseSchurStepOps,
        FlatDenseSchurStepOps,
        FlatIterativeSchurStepOps,
        IterativeSchurStepOps,
        JTForm,
    )
    from ceres_tpu_torch.summary import Summary

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}, float32 matmul "
        f"precision {torch.get_float32_matmul_precision()!r}")
    # the JAX package takes its float32 products at Precision.HIGHEST
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls would run in TF32")
    IS = ctt.LinearSolverType.ITERATIVE_SCHUR
    DS = ctt.LinearSolverType.DENSE_SCHUR

    # -- build ----------------------------------------------------------------
    info = build.build()
    log("build", f"{len(info.ptxas)} sources in {info.seconds:.2f} s "
        f"(reused={info.reused}) -> {info.path.name}")
    for src, text in info.ptxas.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                log(f"ptxas {src}", line.strip())
    build.load()

    def copy_problem(b):
        return bal.build_problem_batched(bal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    def kernel_inputs(prog, opts, dense, rng):
        """Each case's arguments at this program's real first-iteration
        inputs: J and r of the initial state, the Jacobi scales, an LM
        diagonal at radius 1e4, M^{-1} of the scaled point blocks."""
        _, e_fams = _pick_linear_solver(opts, prog, Summary())
        ops = (DenseSchurStepOps if dense else IterativeSchurStepOps)(
            prog, opts, e_fams)
        plan, q, dt = ops.flat.plan, ops._jt_qual, prog.compute_dtype
        x0 = prog.initial_state()
        cams = prog.family_table(x0, q.fam_f).to(dt).contiguous()
        pts = prog.family_table(x0, q.fam_e).to(dt).contiguous()
        obs = prog.kinds[0].data
        P, C = plan.P, plan.C
        _, rT, JT = kn.eval_fused_plain(cams, pts, obs, plan, q.rows_fn)
        g, sqn, aux = ops.post_eval(JTForm(JT, rT))
        sqn64 = sqn.to(torch.float64)
        scale_c = (1.0 / (1.0 + torch.sqrt(sqn64))).to(dt)
        D2_c = (torch.clamp(scale_c.double() ** 2 * sqn64, 1e-6, 1e32) / 1e4).to(dt)
        se = pt.extract_e(ops.pm, scale_c)
        sf = pt.extract_f(ops.pm, scale_c)
        minv = fo.scaled_block_inverses(aux[0], se, pt.extract_e(ops.pm, D2_c), 3)
        minv_folded = ops.flat.make_kernel_suite_raw(JT, se, sf)[3](minv)
        xc = (sf * torch.as_tensor(rng.standard_normal(C * 9), device=dev)
              .to(dt)).reshape(C, 9).contiguous()
        xp = (se * torch.as_tensor(rng.standard_normal(P * 3), device=dev)
              .to(dt)).reshape(P, 3).contiguous()
        args = {
            "eval_fused": (cams, pts, obs, plan, q.rows_fn),
            "post_eval_fused": (JT, rT, plan),
            "normal_matvec": (JT, xc, xp, plan),
            "isc_matvec": (JT, xc, minv_folded, plan, True),
            "isc_matvec_no_u": (JT, xc, minv_folded, plan, False),
            "schur_jacobi_blocks": (JT, se.reshape(P, 3).contiguous(),
                                    minv.contiguous(), plan),
        }
        if dense:
            _, se_d, sf_d, _, K, u_vec = ops.schur_inputs(aux, g, scale_c, D2_c)
            args["schur_assembly"] = (JT, sf_d.reshape(C, 9).contiguous(),
                                      se_d.reshape(P, 3).contiguous(),
                                      K.contiguous(), u_vec.reshape(P, 3).contiguous(),
                                      plan)
        return args

    def flat_kernel_inputs(prog, opts, dense):
        """The flat path's kernel cases at this libmv program's real
        first-iteration inputs: the post-evaluation sums of the point side
        (sorted, w = 15), of the intrinsics (one key holding every row,
        w = 80) and of the cameras (unsorted, w = 48), and random rows at
        the widths a CG iteration sums (3, 8 and 6); the gathers of each
        width a solve launches: the camera scales (t = 6, the row's main
        case), the point scales (3), the intrinsics scales (8) and the
        points' M^{-1} blocks at Jacobi scales and an LM diagonal at radius
        1e4 (9, the SCHUR_JACOBI and dense-Schur gathers); with `dense`,
        the spread sum of the cameras' A rows at those scales."""
        _, e_fams = _pick_linear_solver(opts, prog, Summary())
        ops = (FlatDenseSchurStepOps if dense else FlatIterativeSchurStepOps)(
            prog, opts, e_fams)
        fl, pm = ops.flat, ops.pm
        pe = fl.plans_e[0][0]
        pcam, pintr = sorted(fl.plans_f[0], key=lambda p: -p.nv)
        _, vrep = ops.evaluate(prog.initial_state())
        rows = fl._rows(vrep.r, 0)
        g, sqn, aux = ops.post_eval(vrep)
        dt = prog.compute_dtype
        sqn64 = sqn.to(torch.float64)
        scale_c = (1.0 / (1.0 + torch.sqrt(sqn64))).to(dt)
        sf = pt.extract_f(pm, scale_c)
        se = pt.extract_e(pm, scale_c)
        D2_c = (torch.clamp(scale_c.double() ** 2 * sqn64, 1e-6, 1e32) / 1e4).to(dt)
        minv_e = fl.scaled_block_inverses(pm.e_fams, aux[0], se, pt.extract_e(pm, D2_c))

        def table(v, p):
            return torch.cat([v.reshape(p.nv, -1), v.new_zeros((1, v.numel() // p.nv))])

        gen = torch.Generator(device=dev).manual_seed(3)

        def rows_of(w):  # timing inputs at a CG iteration's widths
            return torch.randn((pe.seg.B, w), generator=gen, dtype=dt, device=dev)

        args = {
            "segment_block_sum": (
                fl.post_contrib(fl._jac(vrep.vflat, 0, pe), rows), pe.seg),
            "segment_block_sum_one_key": (
                fl.post_contrib(fl._jac(vrep.vflat, 0, pintr), rows), pintr.seg),
            "unsorted_segment_sum": (
                fl.post_contrib(fl._jac(vrep.vflat, 0, pcam), rows), pcam.seg),
            "segment_block_sum_w3": (rows_of(3), pe.seg),
            "segment_block_sum_one_key_w8": (rows_of(8), pintr.seg),
            "unsorted_segment_sum_w6": (rows_of(6), pcam.seg),
            "segment_block_expand": (
                table(sf[pcam.off:pcam.off + pcam.nv * pcam.t], pcam), pcam.local),
            "segment_block_expand_t3": (
                table(se[pe.off:pe.off + pe.nv * pe.t], pe), pe.local),
            "segment_block_expand_t8": (
                table(sf[pintr.off:pintr.off + pintr.nv * pintr.t], pintr), pintr.local),
            "segment_block_expand_t9": (table(minv_e[pe.fi], pe), pe.local),
        }
        if dense:
            K_e = ops._scaled_K(aux[0], se, pt.extract_e(pm, D2_c))
            for p_e, p_f, Y in ops.eliminated_rows(vrep.vflat, K_e, se, sf):
                if p_f is pcam:
                    args["segment_spread_sum"] = (
                        Y.reshape(Y.shape[0], -1).contiguous(), p_f.local,
                        p_e.seg.seg_start[:p_e.nv + 1], p_f.nv, p_e.t, p_f.t)
        return args

    checks, timings = {}, {}

    def check_and_time(shape, dtn, args, n_kernel, n_plain, timed=True):
        """Each case's kernel against its plain version on the same
        inputs and, if `timed`, its times and bound."""
        for case, args_c in args.items():
            name = CASES[case]
            wrapper = getattr(kn, name)
            plain = getattr(kn, name + "_plain")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            out = wrapper(*args_c)
            torch.cuda.synchronize()
            # the call's own peak: its outputs and workspaces
            call_peak = torch.cuda.max_memory_allocated() - held
            dt = args_c[0].dtype
            if dt == torch.float64:
                ref = plain(*args_c)
                rel, mabs, per_out = rel_err(ref, out)
                limits = [REL_LIMIT[dt]] * len(per_out)
                log("check", f"{case} {shape} {dtn}: max over outputs of "
                    f"max_abs_err/max_abs = {rel:.3e} (limit {limits[0]:.0e}; each "
                    f"output {', '.join(f'{v:.3e}' for v in per_out)}), "
                    f"max_abs_err {mabs:.3e}")
            else:
                # float32: against the plain version in float64 on the same
                # inputs; the limit is 1e-4 of the largest value, or 4x the
                # float32 plain version's own error where rounding in an
                # ill-conditioned point block (M^{-1} of u) makes that larger
                ref = plain(*upcast(args_c))
                rel, mabs, per_out = rel_err(ref, out)
                _, _, per_plain = rel_err(ref, plain(*args_c))
                limits = [max(REL_LIMIT[dt], 4 * v) for v in per_plain]
                log("check", f"{case} {shape} {dtn}: against the float64 plain "
                    f"version, per output max_abs_err/max_abs "
                    f"{', '.join(f'{v:.3e}' for v in per_out)}; the float32 plain "
                    f"version's own {', '.join(f'{v:.3e}' for v in per_plain)}; "
                    f"limits {', '.join(f'{v:.1e}' for v in limits)}; "
                    f"max_abs_err {mabs:.3e}")
            check(all(v <= lim for v, lim in zip(per_out, limits)),
                  f"{case} {shape} {dtn} disagrees with its plain version")
            check(name != "segment_block_expand" or mabs == 0.0,
                  f"{case} {shape} {dtn}: the gather is a copy, yet differs by {mabs}")
            if name in REPEAT_GATED:
                again = wrapper(*args_c)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(as_tuple(again), as_tuple(out)))
                sym = exactly_symmetric(name, out) if name in EXACTLY_SYMMETRIC else None
                log("check", f"{case} {shape} {dtn}: "
                    + ("" if sym is None else f"exactly symmetric {sym}, ")
                    + f"a repeated call bit for bit {same}")
                check(sym is not False,
                      f"{case} {shape} {dtn}: an output block is not exactly symmetric")
                check(same, f"{case} {shape} {dtn}: a repeated call differs")
                del again
            del ref, out
            checks[(case, shape, dtn)] = (rel, mabs)
            if not timed:
                continue
            ms = time_cuda(lambda: wrapper(*args_c), n_kernel)
            plain_ms = time_cuda(lambda: plain(*args_c), n_plain)
            lib = library_call(name, args_c)
            if lib is not None:
                lib_ms = time_cuda(lib, n_kernel)
                lib_text = f"{lib_ms:.4f} ms ({LIBRARY_CALL[name]})"
            else:
                lib_ms = None
                lib_text = f"none ({NO_LIBRARY_CALL[name]})"
            byts, flops = work(case, args_c)
            t_bytes = byts / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dt] * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            timings[(case, shape, dtn)] = dict(ms=ms, plain_ms=plain_ms,
                                               bound_ms=max(t_bytes, t_ops),
                                               bound_by=bound_by, library_ms=lib_ms,
                                               call_peak_bytes=call_peak)
            if name in PASSES_LOGGED:
                passes(case, shape, dtn, wrapper, args_c, n_kernel)
            log("time", f"{case} {shape} {dtn}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms by {bound_by} "
                f"(counted, not measured: {byts} bytes -> {t_bytes:.4f} ms, "
                f"{flops} flops -> {t_ops:.4f} ms); library call: {lib_text}; the "
                f"call's peak device memory (outputs, workspaces) "
                f"{call_peak / 2**20:.1f} MiB; {card}")
            torch.cuda.synchronize()

    def passes(case, shape, dtn, wrapper, args_c, n_kernel):
        """The device kernels of one call under torch.profiler, with each
        one's device time; for 8J also the slab pass alone (the call
        without Jc: row 8's entry point) by CUDA events, and the F'F passes
        as the rest of the call's time."""
        tm = timings[(case, shape, dtn)]
        for _ in range(3):  # the profiler has returned no device event at times
            n_ops, by_name = device_profile(lambda: wrapper(*args_c))[3:]
            if n_ops:
                break
        tm["device_kernels_per_call"] = n_ops if n_ops else "not measured"
        tm["device_us_by_kernel"] = {kernel_label(k): v for k, v in by_name.items()}
        text = ""
        if CASES[case] == "segment_spread_ftf":
            tm["slab_ms"] = time_cuda(lambda: kn.segment_spread_sum(*args_c[:6]), n_kernel)
            tm["ftf_ms"] = tm["ms"] - tm["slab_ms"]
            text = (f"slab pass alone {tm['slab_ms']:.4f} ms, F'F passes (the rest) "
                    f"{tm['ftf_ms']:.4f} ms; ")
        log("passes", f"{case} {shape} {dtn}: {text}{tm['device_kernels_per_call']} "
            f"device kernels a call, device us by kernel "
            f"{json.dumps(tm['device_us_by_kernel'])}; {card}")
        check(CASES[case] not in EVAL_VARIANTS or n_ops in (0, 1),
              f"{case} {shape} {dtn}: {n_ops} device kernels a call, not one")

    # -- eval_fused's variants on this card -----------------------------------
    for dtn in ("float64", "float32"):
        for model, with_loss in ((0, False), (0, True), (1, False), (1, True)):
            occ = kn.eval_fused_occupancy(dev, getattr(torch, dtn), model, with_loss)
            sms = occ["sms"]
            rows_at_once = occ["threads"] * occ["blocks_per_sm"] * sms
            log("eval_fused occupancy",
                f"{('angle-axis', 'quaternion')[model]}{' + loss' if with_loss else ''} "
                f"{dtn}: {occ['threads']} threads a block, {occ['registers']} registers "
                f"and {occ['local_bytes']} local bytes a thread, {occ['blocks_per_sm']} "
                f"blocks an SM, {rows_at_once} rows at once on {sms} SMs: waves at "
                f"B = 84,218 {84218 / max(rows_at_once, 1):.3f}, at B = 4,397,236 "
                f"{4397236 / max(rows_at_once, 1):.3f}; one launch a call; {card}")

    # -- BAL-16: every kernel against its plain version ----------------------
    log("phase", f"BAL-16 kernel checks from {time.monotonic() - t_start:.1f} s")
    b16 = bal.bal16()
    log("bal16", f"cameras {b16.num_cameras}, points {b16.num_points}, "
        f"observations {b16.num_observations}")
    rng = np.random.default_rng(7)
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(bal.build_problem_batched(bal.bal16())[0], dtn,
                               device=dev)
        args = kernel_inputs(prog, ctt.Options(linear_solver_type=DS), True, rng)
        check_and_time("bal16", dtn, args, 100, 10)
        del prog, args
    b120 = bal.perturb(bal.synthetic_bal(**C120), 0.01, 0.05, 0.05, seed=1)
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(copy_problem(b120), dtn, device=dev)
        args = kernel_inputs(prog, ctt.Options(linear_solver_type=DS), True, rng)
        check_and_time("c120", dtn, {"schur_assembly": args["schur_assembly"]}, 100, 10)
        del prog, args

    paths = {}

    def drive(path, opts, problem, device=None, flat=False, variant="eval_fused",
              kernels=None, extra_evaluations=0, solver=None):
        """One main-path run with the counts set to 0 just before it and
        read just after; `flat` for a program of the flat path; on the jt
        path `variant` is the eval_fused wrapper of the program's model and
        loss, launched exactly once per summary row (the first evaluation
        and one per LM iteration) and `extra_evaluations` more (the mixed
        schedule's float64 phase re-evaluates the iterate the two phases
        share, which its summary holds once), the other variants never. `kernels`, if
        given, are the path's kernels (each launched at least once per LM
        iteration, every other kernel never, normal_matvec at
        least once per CG iteration). `solver(opts, problem, device)` runs
        the solve, ctt.solve by default."""
        kn.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        s = (solver or ctt.solve)(opts, problem, device=device)
        torch.cuda.synchronize()
        launches, plain_calls = counts(kn)
        n_it = len(s.iterations) - 1
        cg = [r.linear_solver_iterations for r in s.iterations]
        res = {"iterations": n_it, "summary_rows": len(s.iterations),
               "termination": str(s.termination_type), "message": s.message,
               "initial_cost": s.initial_cost, "final_cost": s.final_cost,
               "host_syncs": s.num_host_syncs,
               "host_syncs_per_iteration": s.num_host_syncs / max(n_it, 1),
               "linear_solver_iterations": cg,
               "preprocessor_s": s.preprocessor_time_in_seconds,
               "minimizer_s": s.minimizer_time_in_seconds,
               "ms_per_iteration": 1e3 * s.minimizer_time_in_seconds / max(n_it, 1),
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "plain_calls": plain_calls}
        log(f"solve {path}", json.dumps(res) + f"; {card}")
        if device is None:
            check(all(v == 0 for v in plain_calls.values()),
                  f"{path}: a plain version ran on the card")
            if kernels is not None:
                others = set(launches) - set(kernels)
                check("normal_matvec" not in kernels
                      or launches["normal_matvec"] >= sum(cg),
                      f"{path}: normal_matvec launched fewer times than CG iterated")
            elif flat:
                kernels = (FLAT_ITERATIVE_PATH if opts.linear_solver_type == IS
                           else FLAT_DENSE_PATH)
                others = set(launches) - set(kernels)
            else:
                kernels = tuple(variant if k == "eval_fused" else k for k in (
                    ITERATIVE_PATH if opts.linear_solver_type == IS else DENSE_PATH))
                others = set(FLAT_DENSE_PATH) | set(EVAL_VARIANTS) - {variant}
                n_eval = len(s.iterations) + extra_evaluations
                check(launches[variant] == n_eval,
                      f"{path}: {variant} launched {launches[variant]} times for "
                      f"{n_eval} evaluations")
            check(n_it >= 1 and all(launches[k] >= n_it for k in kernels),
                  f"{path}: a kernel of the path launched fewer than once per "
                  f"iteration: {launches}")
            check(all(launches[k] == 0 for k in others),
                  f"{path}: a kernel of the other path launched: {launches}")
            if opts.linear_solver_type == IS and not flat and kernels is None:
                check(launches["isc_matvec"] >= sum(cg),
                      f"{path}: isc_matvec launched fewer times than CG iterated")
                check(launches["schur_assembly"] == 0,
                      f"{path}: the dense assembly ran on the iterative path")
        paths[path] = res
        return s, res

    def large_solves(path, opts, problem_fn, flat=False, variant="eval_fused",
                     kernels=None):
        """A solve at the Venice shape through drive, its gates (every cost
        finite, falling over successful steps) and two more solves, which
        must repeat it bit for bit and time the same work."""
        s, res = drive(path, opts, problem_fn(), flat=flat, variant=variant,
                       kernels=kernels)
        costs = [r.cost for r in s.iterations]
        check(all(np.isfinite(c) for c in costs), f"{path}: a cost is not finite")
        accepted = [s.iterations[0].cost] + [
            r.cost for r in s.iterations[1:] if r.step_is_successful]
        check(len(accepted) >= 2 and all(b < a for a, b in zip(accepted, accepted[1:])),
              f"{path}: the cost did not decrease over successful steps: {accepted}")
        cg = sum(res["linear_solver_iterations"])
        res["cg_iterations_per_lm_iteration"] = cg / max(res["iterations"], 1)
        minimizer_s = [res["minimizer_s"]]
        for _ in range(2):
            s2 = ctt.solve(opts, problem_fn())
            torch.cuda.synchronize()
            check(s2.final_cost == s.final_cost, f"{path}: a repeated solve differs")
            minimizer_s.append(s2.minimizer_time_in_seconds)
        med_s = statistics.median(minimizer_s)
        res["ms_per_iteration_runs"] = [1e3 * v / res["iterations"] for v in minimizer_s]
        res["ms_per_iteration_median"] = 1e3 * med_s / res["iterations"]
        res["minimizer_ms_per_cg_iteration"] = 1e3 * med_s / max(cg, 1)
        log(f"solve {path}", f"CG iterations per LM iteration "
            f"{res['linear_solver_iterations'][1:]}, ms per LM iteration over 3 "
            f"solves: median {res['ms_per_iteration_median']:.3f}, runs "
            + ", ".join(f"{v:.3f}" for v in res["ms_per_iteration_runs"])
            + f"; {res['minimizer_ms_per_cg_iteration']:.4f} ms of minimizer time "
            f"per CG iteration (median), {res['host_syncs_per_iteration']:.2f} "
            f"host syncs per LM iteration, time to first iteration "
            f"{res['preprocessor_s']:.3f} s, peak device memory "
            f"{res['peak_device_bytes'] / 2**30:.3f} GiB; costs {costs}; {card}")
        gc.collect()
        torch.cuda.empty_cache()

    def card_against_cpu(path, opts, problem_fn, ulp_problem_fn, flat=False,
                         kernels=None, solver=None):
        """The same float64 solve on the card (through drive) and on the
        CPU: the same rows and CG counts, and each row's cost within 1e-9,
        or 4x the CPU's own one-ulp sensitivity where that is larger. That
        sensitivity is how far rounding alone moves each row: the same CPU
        solve from cameras one ulp away. A long CG amplifies a
        rounding-level change in S z far past 1e-9, and the card sums in
        another order than the CPU. Where rounding alone changes a row's
        CG count (the one-ulp solve's count differs from the CPU's), the
        card's may be either. `solver` as drive's."""
        s_card, _ = drive(path, opts, problem_fn(), flat=flat, kernels=kernels,
                          solver=solver)
        t0 = time.monotonic()
        s_cpu = (solver or ctt.solve)(opts, problem_fn(), device="cpu")
        cpu_s = time.monotonic() - t0
        s_ulp = (solver or ctt.solve)(opts, ulp_problem_fn(), device="cpu")
        rows_card = [(r.linear_solver_iterations, r.cost) for r in s_card.iterations]
        rows_cpu = [(r.linear_solver_iterations, r.cost) for r in s_cpu.iterations]
        rows_ulp = [(r.linear_solver_iterations, r.cost) for r in s_ulp.iterations]
        # a row a tolerance ends the host loop on holds cost 0 (as the JAX
        # package's): its gap is the absolute difference
        gaps = [abs(a[1] - b[1]) / (abs(b[1]) or 1.0) for a, b in zip(rows_card, rows_cpu)]
        sens = [abs(a[1] - b[1]) / (abs(b[1]) or 1.0) for a, b in zip(rows_ulp, rows_cpu)]
        limits = [max(1e-9, 4 * v) for v in sens]
        log(f"{path} card vs cpu", f"card rows {rows_card}; cpu rows {rows_cpu} (cpu "
            f"solve {cpu_s:.1f} s); relative cost gap per row "
            f"{', '.join(f'{g:.3e}' for g in gaps)}; the CPU's one-ulp sensitivity per "
            f"row {', '.join(f'{g:.3e}' for g in sens)} (CG counts "
            f"{[n for n, _ in rows_ulp]}); limits {', '.join(f'{g:.1e}' for g in limits)}; "
            f"{card}")
        check(len(rows_card) == len(rows_cpu) == len(rows_ulp),
              f"{path}: card and CPU row counts differ")
        loose = [i for i, (b, u) in enumerate(zip(rows_cpu, rows_ulp)) if b[0] != u[0]]
        check(all(a[0] == b[0] or (i in loose and a[0] == u[0]) for i, (a, b, u)
                  in enumerate(zip(rows_card, rows_cpu, rows_ulp))),
              f"{path}: card and CPU CG counts differ (rows whose count rounding "
              f"alone changes: {loose})")
        check(all(g <= lim for g, lim in zip(gaps, limits)),
              f"{path}: card and CPU costs differ: {gaps}")
        paths[path]["cpu_rows"] = rows_cpu
        paths[path]["relative_cost_gaps_to_cpu"] = gaps
        paths[path]["cpu_one_ulp_sensitivity"] = sens
        paths[path]["rows_whose_cg_count_rounding_changes"] = loose
        log(f"{path} card vs cpu", f"rows whose CG count the one-ulp CPU solve "
            f"changes: {loose}; card CG counts {[a[0] for a in rows_card]}")

    # -- robust losses and quaternion cameras: eval_fused's loss and ---------
    # -- manifold branches (rows 1L, 1Q) on BAL-16 -----------------------------
    log("phase", f"robust losses and quaternion cameras on BAL-16 from "
        f"{time.monotonic() - t_start:.1f} s")
    robust_phase(ctt, bal, kn, dev, card, b16, paths, check_and_time, drive)

    # -- the specialized pipeline (parallel/sharded_ba.py, bench.py:131) ------
    log("phase", f"the specialized pipeline from {time.monotonic() - t_start:.1f} s")
    specialized_phase(dev, card, b16, paths, check_and_time)

    # -- BAL-16 DENSE_SCHUR (slice 1's gates) ---------------------------------
    log("phase", f"BAL-16 solves from {time.monotonic() - t_start:.1f} s")
    for dtn in ("float64", "float32"):
        s, res = drive("bal16_dense_" + TAG[dtn],
                       ctt.Options(linear_solver_type=DS, evaluation_dtype=dtn),
                       bal.build_problem_batched(bal.bal16())[0])
        gap = (s.final_cost - GOLDEN_COST) / GOLDEN_COST
        res["gap_to_golden"] = gap
        if dtn == "float64":
            check(s.termination_type == ctt.TerminationType.CONVERGENCE,
                  "float64 solve did not converge")
            check(abs(gap) <= 1e-6, f"float64 final cost off golden by {gap:.3e}")
            log("solve bal16_dense_f64", f"summary rows {len(s.iterations)} "
                f"(golden {GOLDEN_ROWS}), relative gap {gap:.3e} (limit 1e-6)")
        else:
            check(abs(gap) <= 1e-5, f"float32 final cost off golden by {gap:.3e}")
            log("solve bal16_dense_f32", f"relative gap to the float64 golden "
                f"{gap:.3e} (limit 1e-5)")

    # -- BAL-16 ITERATIVE_SCHUR + SCHUR_JACOBI (tests/test_bal_golden.py) ----
    for dtn in ("float64", "float32"):
        path = "bal16_iterative_" + TAG[dtn]
        opts = ctt.Options(linear_solver_type=IS,
                           preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
                           evaluation_dtype=dtn, max_num_iterations=30,
                           max_linear_solver_iterations=100)
        s, res = drive(path, opts, bal.build_problem_batched(bal.bal16())[0])
        gap = (s.final_cost - GOLDEN_COST) / GOLDEN_COST
        res["gap_to_golden"] = gap
        check(s.is_solution_usable(), f"{path}: solution not usable: {s.message}")
        check(s.final_cost <= GOLDEN_COST * (1 + 1e-4),
              f"{path}: final cost {s.final_cost} above golden x (1 + 1e-4)")
        log(f"solve {path}", f"final cost {s.final_cost!r}, relative gap to the "
            f"float64 DENSE_SCHUR golden {gap:.3e} (gate: <= 1e-4)")

    # -- ms per LM iteration on BAL-16, median of 5 solves --------------------
    for path, opts in (
            ("bal16_dense_f64", ctt.Options(linear_solver_type=DS)),
            ("bal16_dense_f32", ctt.Options(linear_solver_type=DS,
                                            evaluation_dtype="float32")),
            ("bal16_iterative_f64", ctt.Options(
                linear_solver_type=IS, max_num_iterations=30,
                max_linear_solver_iterations=100)),
            ("bal16_iterative_f32", ctt.Options(
                linear_solver_type=IS, evaluation_dtype="float32",
                max_num_iterations=30, max_linear_solver_iterations=100))):
        per_it = []
        for _ in range(5):
            s = ctt.solve(opts, bal.build_problem_batched(bal.bal16())[0])
            torch.cuda.synchronize()
            per_it.append(1e3 * s.minimizer_time_in_seconds / (len(s.iterations) - 1))
        paths[path]["ms_per_iteration_runs"] = per_it
        paths[path]["ms_per_iteration_median"] = statistics.median(per_it)
        log(f"solve {path}", "ms per LM iteration (minimizer time / iterations) "
            f"over 5 solves: median {statistics.median(per_it):.4f}, runs "
            + ", ".join(f"{v:.4f}" for v in per_it) + f"; {card}")

    # -- device busy share over one BAL-16 solve of each path -----------------
    for path, opts in (("bal16_dense_f64", ctt.Options(linear_solver_type=DS)),
                       ("bal16_iterative_f64", ctt.Options(
                           linear_solver_type=IS, max_num_iterations=30,
                           max_linear_solver_iterations=100))):
        paths[path]["profile"] = profile_solve(
            lambda: ctt.solve(opts, bal.build_problem_batched(bal.bal16())[0]))
        log(f"profile {path}", json.dumps(paths[path]["profile"]) + f"; {card}")
        log_row_passes(path, paths[path]["profile"], card)

    # -- libmv16: the flat path's kernels against their plain versions -------
    log("phase", f"libmv16 from {time.monotonic() - t_start:.1f} s")
    lp16 = libmv16()
    log("libmv16", f"cameras {lp16.cameras.shape[0]}, points {lp16.points.shape[0]}, "
        f"markers {lp16.markers.shape[0]}, one shared intrinsics block")
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(libmv.build_problem(fresh(lp16))[0], dtn, device=dev)
        args = flat_kernel_inputs(prog, ctt.Options(linear_solver_type=DS), True)
        check_and_time("libmv16", dtn, args, 100, 10)
        del prog, args

    # -- libmv16 DENSE_SCHUR against the JAX package's answer -----------------
    for dtn in ("float64", "float32"):
        path = "libmv16_dense_" + TAG[dtn]
        s, res = drive(path, ctt.Options(linear_solver_type=DS, evaluation_dtype=dtn),
                       libmv.build_problem(fresh(lp16))[0], flat=True)
        gap = (s.final_cost - LIBMV16_GOLDEN_COST) / LIBMV16_GOLDEN_COST
        res["gap_to_golden"] = gap
        if dtn == "float64":
            check(s.termination_type == ctt.TerminationType.CONVERGENCE,
                  f"{path}: did not converge")
            check(abs(gap) <= 1e-6, f"{path}: final cost off golden by {gap:.3e}")
            check(len(s.iterations) == LIBMV16_GOLDEN_ROWS,
                  f"{path}: {len(s.iterations)} rows, golden {LIBMV16_GOLDEN_ROWS}")
        else:
            check(abs(gap) <= 1e-5, f"{path}: final cost off golden by {gap:.3e}")
        log(f"solve {path}", f"final cost {s.final_cost!r}, summary rows "
            f"{len(s.iterations)} (golden {LIBMV16_GOLDEN_ROWS}), relative gap to the "
            f"float64 golden {gap:.3e} (limit {1e-6 if dtn == 'float64' else 1e-5:.0e})")

    # -- libmv16 ITERATIVE_SCHUR + SCHUR_JACOBI --------------------------------
    for dtn in ("float64", "float32"):
        path = "libmv16_iterative_" + TAG[dtn]
        opts = ctt.Options(linear_solver_type=IS, evaluation_dtype=dtn,
                           preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI)
        s, res = drive(path, opts, libmv.build_problem(fresh(lp16))[0], flat=True)
        gap = (s.final_cost - LIBMV16_GOLDEN_COST) / LIBMV16_GOLDEN_COST
        res["gap_to_golden"] = gap
        check(s.is_solution_usable(), f"{path}: solution not usable: {s.message}")
        check(s.final_cost <= LIBMV16_GOLDEN_COST * (1 + 1e-4),
              f"{path}: final cost {s.final_cost} above golden x (1 + 1e-4)")
        log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows, "
            f"relative gap to the float64 DENSE_SCHUR golden {gap:.3e} (gate: <= 1e-4)")

    for path, opts in (
            ("libmv16_dense_f64", ctt.Options(linear_solver_type=DS)),
            ("libmv16_dense_f32", ctt.Options(linear_solver_type=DS,
                                              evaluation_dtype="float32")),
            ("libmv16_iterative_f64", ctt.Options(linear_solver_type=IS)),
            ("libmv16_iterative_f32", ctt.Options(linear_solver_type=IS,
                                                  evaluation_dtype="float32"))):
        per_it = []
        for _ in range(3):
            s = ctt.solve(opts, libmv.build_problem(fresh(lp16))[0])
            torch.cuda.synchronize()
            per_it.append(1e3 * s.minimizer_time_in_seconds / (len(s.iterations) - 1))
        paths[path]["ms_per_iteration_runs"] = per_it
        paths[path]["ms_per_iteration_median"] = statistics.median(per_it)
        log(f"solve {path}", "ms per LM iteration over 3 solves: median "
            f"{statistics.median(per_it):.4f}, runs " + ", ".join(f"{v:.4f}" for v in per_it)
            + f"; time to first iteration {paths[path]['preprocessor_s']:.3f} s, peak "
            f"device memory {paths[path]['peak_device_bytes'] / 2**30:.3f} GiB; {card}")
    for path, opts in (("libmv16_dense_f64", ctt.Options(linear_solver_type=DS)),
                       ("libmv16_iterative_f64", ctt.Options(linear_solver_type=IS))):
        paths[path]["profile"] = profile_solve(
            lambda: ctt.solve(opts, libmv.build_problem(fresh(lp16))[0]),
            anchor=SEGMENT_SUM_ANCHOR)
        log(f"profile {path}", json.dumps(paths[path]["profile"]) + f"; {card}")
        log_row_passes(path, paths[path]["profile"], card)

    # -- libmv16: the card against the CPU --------------------------------------
    ulp16 = fresh(lp16)
    ulp16.cameras = np.nextafter(lp16.cameras, np.inf)
    for path, opts in (
            ("libmv16_dense_card_vs_cpu", ctt.Options(
                linear_solver_type=DS, max_num_iterations=LIBMV16_CARD_VS_CPU_ITERATIONS)),
            ("libmv16_iterative_card_vs_cpu", ctt.Options(
                linear_solver_type=IS, max_num_iterations=LIBMV16_CARD_VS_CPU_ITERATIONS))):
        card_against_cpu(path, opts, lambda: libmv.build_problem(fresh(lp16))[0],
                         lambda: libmv.build_problem(fresh(ulp16))[0], flat=True)

    # -- port slice 11: CGNR, dogleg and the dense solvers ----------------------
    log("phase", f"CGNR, dogleg and MGH from {time.monotonic() - t_start:.1f} s")
    cgnr_dogleg_mgh_phase(ctt, bal, libmv, kn, dev, card, paths, drive,
                          card_against_cpu, check_and_time, lp16, ulp16)

    # -- the modeling API ------------------------------------------------------
    log("phase", f"the modeling API from {time.monotonic() - t_start:.1f} s")
    modeling_phase(ctt, bal, libmv, kn, dev, card, paths, drive, check_and_time,
                   kernel_inputs, b16, lp16, rng)

    # -- the host trust-region loop ------------------------------------------------
    log("phase", f"the host loop from {time.monotonic() - t_start:.1f} s")
    host_loop_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu)

    # -- the Venice shape ------------------------------------------------------
    log("phase", f"the Venice shape from {time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    venice = bal.perturb(bal.synthetic_bal_large(**VENICE), **VENICE_PERTURB)
    log("venice", f"cameras {venice.num_cameras}, points {venice.num_points}, "
        f"observations {venice.num_observations}; generated in "
        f"{time.monotonic() - t0:.2f} s on the host")
    for dtn in ("float32", "float64"):
        prog = CompiledProgram(copy_problem(venice), dtn, device=dev)
        args = kernel_inputs(prog, ctt.Options(linear_solver_type=IS), False, rng)
        check_and_time("venice", dtn, args, 20, 3)
        del prog, args
        gc.collect()
        torch.cuda.empty_cache()

    for dtn in ("float32", "float64"):
        opts = ctt.Options(linear_solver_type=IS, evaluation_dtype=dtn,
                           max_num_iterations=VENICE_LM_ITERATIONS)
        large_solves("venice_iterative_" + TAG[dtn], opts, lambda: copy_problem(venice))
    for dtn in ("float32", "float64"):
        path = "venice_iterative_" + TAG[dtn]
        opts = ctt.Options(linear_solver_type=IS, evaluation_dtype=dtn,
                           max_num_iterations=2)
        paths[path]["profile"] = profile_solve(
            lambda: ctt.solve(opts, copy_problem(venice)))
        log(f"profile {path} (2 LM iterations)",
            json.dumps(paths[path]["profile"]) + f"; {card}")
        log_row_passes(path, paths[path]["profile"], card)

    # -- CGNR + JACOBI at the Venice shape, float32: row 4 at 4.4M rows ------
    path = "venice_cgnr_f32"
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.CGNR,
                       evaluation_dtype="float32", max_num_iterations=VENICE_LM_ITERATIONS)
    large_solves(path, opts, lambda: copy_problem(venice), kernels=CGNR_PATH)
    paths[path]["profile"] = profile_solve(
        lambda: ctt.solve(dataclasses.replace(opts, max_num_iterations=2),
                          copy_problem(venice)), anchor=SEGMENT_SUM_ANCHOR)
    log(f"profile {path} (2 LM iterations)", json.dumps(paths[path]["profile"])
        + f"; normal_matvec (row 4) launches in the 5-iteration solve "
        f"{paths[path]['launches']['normal_matvec']} for "
        f"{sum(paths[path]['linear_solver_iterations'])} CG iterations; {card}")
    log_row_passes(path, paths[path]["profile"], card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the host loop at the Venice shape through a logging callback -----------
    host_loop_venice(ctt, bal, card, paths, large_solves, lambda: copy_problem(venice))

    # -- the Venice shape with HuberLoss(1.0): rows 1L and 1Q at 4.4M rows, --
    # -- and quaternion cameras through ITERATIVE_SCHUR -------------------------
    log("phase", f"the Venice shape with HuberLoss(1.0) from "
        f"{time.monotonic() - t_start:.1f} s")
    for dtn in ("float32", "float64"):
        for case, model in (("eval_fused_loss", "angle_axis"), ("eval_fused_quat", "quat")):
            prog = CompiledProgram(robust_problem(bal, venice, model, ctt.HuberLoss(1.0)),
                                   dtn, device=dev)
            check_and_time("venice", dtn, {case: eval_args(prog)}, 20, 3)
            del prog
            gc.collect()
            torch.cuda.empty_cache()
    for dtn in ("float32", "float64"):
        opts = ctt.Options(linear_solver_type=IS, evaluation_dtype=dtn,
                           max_num_iterations=VENICE_LM_ITERATIONS)
        large_solves("venice_quat_huber_iterative_" + TAG[dtn], opts,
                     lambda: robust_problem(bal, venice, "quat", ctt.HuberLoss(1.0)),
                     variant="eval_fused_quat")
    del venice
    gc.collect()
    torch.cuda.empty_cache()

    # -- libmv-Venice: the flat path at the large end ----------------------------
    log("phase", f"libmv-Venice from {time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    lpv = libmv_venice()
    log("libmv_venice", f"cameras {lpv.cameras.shape[0]}, points {lpv.points.shape[0]}, "
        f"markers {lpv.markers.shape[0]}; generated in {time.monotonic() - t0:.2f} s "
        f"on the host")
    for dtn in ("float32", "float64"):
        prog = CompiledProgram(libmv.build_problem(fresh(lpv))[0], dtn, device=dev)
        args = flat_kernel_inputs(prog, ctt.Options(linear_solver_type=IS), False)
        check_and_time("libmv_venice", dtn, args, 20, 3)
        del prog, args
        gc.collect()
        torch.cuda.empty_cache()
    for dtn in ("float32", "float64"):
        opts = ctt.Options(linear_solver_type=IS, evaluation_dtype=dtn,
                           max_num_iterations=VENICE_LM_ITERATIONS)
        large_solves("libmv_venice_iterative_" + TAG[dtn], opts,
                     lambda: libmv.build_problem(fresh(lpv))[0], flat=True)
    opts = ctt.Options(linear_solver_type=IS, evaluation_dtype="float32",
                       max_num_iterations=2)
    paths["libmv_venice_iterative_f32"]["profile"] = profile_solve(
        lambda: ctt.solve(opts, libmv.build_problem(fresh(lpv))[0]),
        anchor=SEGMENT_SUM_ANCHOR)
    log("profile libmv_venice_iterative_f32 (2 LM iterations)",
        json.dumps(paths["libmv_venice_iterative_f32"]["profile"]) + f"; {card}")
    log_row_passes("libmv_venice_iterative_f32", paths["libmv_venice_iterative_f32"]["profile"],
                   card)
    del lpv
    gc.collect()
    torch.cuda.empty_cache()

    # -- 2,048 cameras: the card against the CPU --------------------------------
    log("phase", f"2,048 cameras, card against CPU from {time.monotonic() - t_start:.1f} s")
    small = bal.perturb(bal.synthetic_bal_large(**SMALL_VENICE), **VENICE_PERTURB)
    ulp = bal.from_arrays(np.nextafter(small.cameras, np.inf), small.points,
                          small.camera_index, small.point_index, small.observations)
    card_against_cpu("c2048_iterative_f64",
                     ctt.Options(linear_solver_type=IS,
                                 max_num_iterations=SMALL_VENICE_LM_ITERATIONS),
                     lambda: copy_problem(small), lambda: copy_problem(ulp))

    # -- segment_block_expand against torch.index_select, per width ------------
    for shp in ("libmv16", "libmv_venice"):
        for dtn in ("float64", "float32"):
            parts = []
            for case in ["segment_block_expand"] + [c for c, _, *own in ROW_CASES["7"]
                                                    if not own]:
                tm = timings[(case, shp, dtn)]
                parts.append(f"{case}: {tm['ms']:.4f} ms, index_select "
                             f"{tm['library_ms']:.4f} ms ({tm['ms'] / tm['library_ms']:.2f}x), "
                             f"bound {tm['bound_ms']:.4f} ms ({tm['ms'] / tm['bound_ms']:.2f}x)")
            log("expand vs index_select", f"{shp} {dtn}: " + "; ".join(parts) + f"; {card}")

    # -- segment sums at a flat CG iteration's widths against index_add ------
    for shp in ("libmv16", "libmv_venice"):
        for dtn in ("float64", "float32"):
            parts = []
            for case in ("segment_block_sum_w3", "segment_block_sum_one_key_w8",
                         "unsorted_segment_sum_w6"):
                tm = timings[(case, shp, dtn)]
                parts.append(f"{case}: {tm['ms']:.4f} ms, index_add "
                             f"{tm['library_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
                             f"({tm['ms'] / tm['bound_ms']:.2f}x)")
            log("segment sums at CG widths", f"{shp} {dtn}: " + "; ".join(parts)
                + f"; {card}")

    # -- the kernels line ------------------------------------------------------
    K = SPECIALIZED_K
    rows = []
    for row, name, src, replaces in ROWS:
        shape = ROW_SHAPE[row]
        entry = {"row": row, "name": name, "route": "cuda",
                 "source": f"ceres_tpu_torch/csrc/{src}.cu", "replaces": replaces,
                 "shape": shape, "launches": paths[ROW_PATH[row]]["launches"][name],
                 "launches_by_path": {p: r["launches"][name] for p, r in paths.items()}}
        for case, tag, *own in [(name, "")] + ROW_CASES.get(row, []):
            for shp in (own[0] if own else [shape] + ROW_VARIANTS.get(row, [])):
                for dtn in ("float64", "float32"):
                    suffix = (tag + ("" if shp == shape else "_" + shp.split("_")[-1])
                              + ("_f32" if dtn == "float32" else ""))
                    rel, mabs = checks[(case, shp, dtn)]
                    entry.update({"max_abs_err" + suffix: mabs, "rel_err" + suffix: rel})
                    entry.update({k + suffix: v
                                  for k, v in timings[(case, shp, dtn)].items()})
        # the row's calls on the specialized pipeline, at their own inputs
        for case in dict.fromkeys(c for cs in SPECIALIZED_CASES.values()
                                  for c, _, _ in cs if CASES[c] == name and c != name):
            for dtn in ("float64", "float32"):
                suffix = ("_spec" + case[len(name):]
                          + ("_f32" if dtn == "float32" else ""))
                rel, mabs = checks[(case, "bal16_specialized", dtn)]
                entry.update({"max_abs_err" + suffix: mabs, "rel_err" + suffix: rel})
                entry.update({k + suffix: v for k, v in
                              timings[(case, "bal16_specialized", dtn)].items()})
        rows.append(entry)
    per_path_kernel_ms, untimed = {}, {}
    for path, res in paths.items():
        if (path.startswith("c2048") or path.endswith("card_vs_cpu")
                or not any(res["launches"].values())):
            continue
        dtn = "float32" if path.endswith("f32") else "float64"
        if path.startswith("specialized"):
            # each call at its own inputs; drive_k held the launches exact
            per_path_kernel_ms[path] = sum(
                timings[(case, "bal16_specialized", dtn)]["ms"] * (a * K + b)
                for case, a, b in SPECIALIZED_CASES[path.split("_")[1]]) / K
            continue
        shp = next(p for p in ("libmv_venice", "libmv16", "venice", "bal16")
                   if path.startswith(p))
        total, missing = 0.0, []
        for k, n in res["launches"].items():
            key = (k, shp, dtn)
            if k == "normal_matvec" and path.startswith("bal16_cgnr"):
                key = ("normal_matvec_cgnr", shp, dtn)
            if n and key in timings:
                total += timings[key]["ms"] * n
            elif n:
                missing.append(k)
        per_path_kernel_ms[path] = total / max(res["iterations"], 1)
        if missing:
            untimed[path] = missing
    log("kernels", "device time of the kernels per LM iteration (kernel ms x "
        "launches / iterations): " + json.dumps(per_path_kernel_ms) + "; kernels a path "
        "launched that were not timed at its shape, left out of its sum: "
        + json.dumps(untimed) + f"; {card}")
    log("total", f"chip_smoke ran {time.monotonic() - t_start:.1f} s")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def cgnr_dogleg_mgh_phase(ctt, bal, libmv, kn, dev, card, paths, drive,
                          card_against_cpu, check_and_time, lp16, ulp16):
    """Port slice 11's paths: row 4 at BAL-16 CGNR's first CG iteration;
    BAL-16 CGNR + JACOBI in both dtypes against CGNR16_GOLDEN, and on the
    card against the CPU; libmv16 CGNR (the flat chain) on the card against
    the CPU; BAL-16 DENSE_SCHUR with both doglegs against DOGLEG16_GOLDEN;
    MGH 1-19 with DENSE_QR and DENSE_NORMAL_CHOLESKY on the card (17 of 19)
    against the same solves on the CPU."""
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.fused_lm import CgnrStepOps

    CGNR = ctt.LinearSolverType.CGNR

    # -- row 4 at the inputs of BAL-16 CGNR's first CG iteration: the lanes
    # -- of the flat evaluation and p = M^{-1} (s * g), at Jacobi scales
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(bal.build_problem_batched(bal.bal16())[0], dtn, device=dev)
        ops = CgnrStepOps(prog, ctt.Options(linear_solver_type=CGNR))
        fl = ops.flat
        _, vrep = ops.evaluate(prog.initial_state())
        g, sqn, aux = ops.post_eval(vrep)
        sqn64 = sqn.to(torch.float64)
        scale_c = (1.0 / (1.0 + torch.sqrt(sqn64))).to(prog.compute_dtype)
        D2_c = (torch.clamp(scale_c.double() ** 2 * sqn64, 1e-6, 1e32) / 1e4).to(
            prog.compute_dtype)
        invs = fl.scaled_block_inverses(fl.fams, aux, scale_c, D2_c)
        p = fl.apply_inverse_rows(fl.fams, invs, scale_c * g)
        pe, pf = fl.kernel_slots
        P, C = pe.nv, pf.nv
        se = scale_c[pe.off:pe.off + 3 * P].reshape(P, 3)
        sf = scale_c[pf.off:pf.off + 9 * C].reshape(C, 9)
        xc = (sf * p[pf.off:pf.off + 9 * C].reshape(C, 9)).contiguous()
        xp = (se * p[pe.off:pe.off + 3 * P].reshape(P, 3)).contiguous()
        check_and_time("bal16", dtn, {"normal_matvec_cgnr": (vrep.jt, xc, xp, fl.plan)},
                       100, 10)
        del prog, ops, vrep, aux

    # -- BAL-16 CGNR + JACOBI against the JAX package's answers ------------------
    for dtn in ("float64", "float32"):
        path = "bal16_cgnr_" + TAG[dtn]
        s, res = drive(path, ctt.Options(linear_solver_type=CGNR, evaluation_dtype=dtn),
                       bal.build_problem_batched(bal.bal16())[0], kernels=CGNR_PATH)
        gap = (s.final_cost - CGNR16_GOLDEN["float64"]) / CGNR16_GOLDEN["float64"]
        gap_dt = (s.final_cost - CGNR16_GOLDEN[dtn]) / CGNR16_GOLDEN[dtn]
        res.update(gap_to_golden=gap, gap_to_golden_of_its_dtype=gap_dt)
        limit = 1e-6 if dtn == "float64" else 1e-5
        check(s.termination_type == ctt.TerminationType.CONVERGENCE,
              f"{path}: did not converge: {s.message}")
        check(abs(gap) <= limit, f"{path}: final cost off the float64 golden by {gap:.3e}")
        log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows, "
            f"relative gap to the JAX package's float64 CGNR {gap:.3e} (limit {limit:.0e}), "
            f"to its {dtn} CGNR {gap_dt:.3e}; CG iterations "
            f"{res['linear_solver_iterations']}; normal_matvec (row 4) launches "
            f"{res['launches']['normal_matvec']}; {res['host_syncs']} host syncs; "
            f"{res['ms_per_iteration']:.3f} ms per LM iteration; {card}")
    paths["bal16_cgnr_f64"]["profile"] = profile_solve(
        lambda: ctt.solve(ctt.Options(linear_solver_type=CGNR),
                          bal.build_problem_batched(bal.bal16())[0]),
        anchor=SEGMENT_SUM_ANCHOR)
    log("profile bal16_cgnr_f64", json.dumps(paths["bal16_cgnr_f64"]["profile"])
        + f"; {card}")
    log_row_passes("bal16_cgnr_f64", paths["bal16_cgnr_f64"]["profile"], card)
    ulp16b = bal.bal16()
    ulp16b.cameras[...] = np.nextafter(ulp16b.cameras, np.inf)
    card_against_cpu(
        "bal16_cgnr_card_vs_cpu",
        ctt.Options(linear_solver_type=CGNR,
                    max_num_iterations=CGNR16_CARD_VS_CPU_ITERATIONS),
        lambda: bal.build_problem_batched(bal.bal16())[0],
        lambda: bal.build_problem_batched(bal.from_arrays(
            ulp16b.cameras, ulp16b.points, ulp16b.camera_index, ulp16b.point_index,
            ulp16b.observations))[0], kernels=CGNR_PATH)

    # -- libmv16 CGNR: the flat chain, card against CPU --------------------------
    card_against_cpu(
        "libmv16_cgnr_f64",
        ctt.Options(linear_solver_type=CGNR,
                    max_num_iterations=LIBMV16_CGNR_CARD_VS_CPU_ITERATIONS),
        lambda: libmv.build_problem(fresh(lp16))[0],
        lambda: libmv.build_problem(fresh(ulp16))[0], flat=True, kernels=FLAT_ITERATIVE_PATH)

    # -- BAL-16 DENSE_SCHUR with dogleg: the flat Schur path ---------------------
    for dogleg, path in (("TRADITIONAL_DOGLEG", "bal16_dogleg_dense_f64"),
                         ("SUBSPACE_DOGLEG", "bal16_subspace_dogleg_dense_f64")):
        opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                           trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
                           dogleg_type=ctt.DoglegType[dogleg])
        s, res = drive(path, opts, bal.build_problem_batched(bal.bal16())[0],
                       kernels=FLAT_DENSE_PATH)
        gap = (s.final_cost - DOGLEG16_GOLDEN[dogleg]) / DOGLEG16_GOLDEN[dogleg]
        res["gap_to_golden"] = gap
        check(s.termination_type == ctt.TerminationType.CONVERGENCE,
              f"{path}: did not converge: {s.message}")
        check(abs(gap) <= 1e-6, f"{path}: final cost off golden by {gap:.3e}")
        log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows, "
            f"relative gap to the JAX package's {gap:.3e} (limit 1e-6); "
            f"{res['host_syncs']} host syncs; {res['ms_per_iteration']:.3f} ms per LM "
            f"iteration; {card}")
        res["profile"] = profile_solve(
            lambda: ctt.solve(opts, bal.build_problem_batched(bal.bal16())[0]),
            anchor=SEGMENT_SUM_ANCHOR)
        log(f"profile {path}", json.dumps(res["profile"]) + f"; {card}")
        log_row_passes(path, res["profile"], card)

    # -- MGH 1-19 with the dense solvers in the fused loop, on the card and on
    # -- the CPU
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        mgh_card_vs_cpu(ctt, kn, dev, card, paths, "mgh_" + lst.lower(),
                        {"linear_solver_type": ctt.LinearSolverType[lst],
                         "fused_loop": "ALWAYS"}, MGH_MISSES)


# -- the host trust-region loop (port slice 13) ---------------------------------

def host_dogleg_solve(ctt, opts, problem, device=None):
    """The host minimizer over ITERATIVE_SCHUR, built as the JAX classes allow
    (solve() refuses DOGLEG with an iterative solver, as Options.is_valid
    does in both packages): a solve() of its own that fills the summary's
    rows, costs and times and writes the answer back."""
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.bsr_kernels import BlockTrustRegionKernels
    from ceres_tpu_torch.solvers.trust_region import TrustRegionMinimizer
    from ceres_tpu_torch.utils import ordering

    t0 = time.monotonic()
    prog = CompiledProgram(problem, opts.evaluation_dtype, device=device)
    kernels = BlockTrustRegionKernels(prog, opts, "ITERATIVE_SCHUR",
                                      e_families=ordering.eligible_e_sets(prog))
    s = ctt.Summary()
    s.preprocessor_time_in_seconds = time.monotonic() - t0
    m = TrustRegionMinimizer(prog, kernels, opts, s)
    t1 = time.monotonic()
    x = m.minimize(prog.initial_state())
    s.minimizer_time_in_seconds = time.monotonic() - t1
    prog.write_state(x)
    s.final_cost = m.x_cost
    return s


def sphere_problem(ctt):
    """A unit-vector fit: 40 noisy unit vectors around (1, 2, 2) / 3, x on
    SphereManifold(3) (scripts/hostloop16_golden.sphere_case)."""
    rng = np.random.default_rng(21)
    u = np.array([1.0, 2.0, 2.0]) / 3.0
    v = u + 0.1 * rng.standard_normal((40, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    x = np.array([1.0, 0.0, 0.2]) / np.linalg.norm([1.0, 0.0, 0.2])
    p = ctt.Problem()
    cost = ctt.AutoDiffCostFunction(lambda x, vi: x - vi, 3, [3])
    for vi in v:
        p.add_residual_block(cost, None, [x], data=vi)
    p.set_manifold(x, ctt.SphereManifold(3))
    return p, x


def line_problem(ctt):
    """A 3-D line fit: 30 noisy points along a line, (origin, direction) on
    LineManifold(3) (scripts/hostloop16_golden.line_case)."""
    rng = np.random.default_rng(22)
    o = np.array([1.0, -1.0, 0.5])
    d = np.array([1.0, 2.0, 3.0]) / np.linalg.norm([1.0, 2.0, 3.0])
    t = np.linspace(-2.0, 2.0, 30)
    pts = o + t[:, None] * d + 0.05 * rng.standard_normal((30, 3))
    d0 = np.array([1.0, 0.5, 0.2]) / np.linalg.norm([1.0, 0.5, 0.2])
    x = np.concatenate([np.zeros(3), d0])

    def residual(x, pi):
        o, d = x[:3], x[3:]
        d = d / torch.sqrt(torch.sum(d * d))
        r = pi - o
        return r - torch.sum(r * d) * d

    p = ctt.Problem()
    cost = ctt.AutoDiffCostFunction(residual, 3, [6])
    for pi in pts:
        p.add_residual_block(cost, None, [x], data=pi)
    p.set_manifold(x, ctt.LineManifold(3))
    return p, x


def _cross(u, v):
    return torch.stack([u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                        u[0] * v[1] - u[1] * v[0]])


def _quaternion_plus(x, delta):
    """QuaternionManifold's Plus (manifold.cc), [w, x, y, z]: the rotation
    of angle |delta| about delta, times x."""
    norm2 = torch.sum(delta * delta)
    pos = norm2 > 0
    safe = torch.sqrt(torch.where(pos, norm2, torch.ones_like(norm2)))
    one = torch.ones_like(norm2)
    w = torch.where(pos, torch.cos(safe), one)
    v = torch.where(pos, torch.sin(safe) / safe, one) * delta
    return torch.cat([(w * x[0] - torch.sum(v * x[1:]))[None],
                      w * x[1:] + x[0] * v + _cross(v, x[1:])])


def _quaternion_minus(y, x):
    """QuaternionManifold's Minus: the angle-axis vector of y x^-1."""
    xc = torch.cat([x[:1], -x[1:]])
    w = y[0] * xc[0] - torch.sum(y[1:] * xc[1:])
    u = y[0] * xc[1:] + xc[0] * y[1:] + _cross(y[1:], xc[1:])
    s2 = torch.sum(u * u)
    small = s2 <= float(np.finfo(np.float64).eps)
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    k = torch.where(small, 1.0 / safe_w - s2 / (3.0 * safe_w ** 3), torch.atan2(s, w) / s)
    return k * u


def quaternion_problem(ctt):
    """A rotation fit: 20 vectors rotated by a unit quaternion with noise,
    q on the quaternion manifold written as an AutoDiffManifold of its Plus
    and Minus (scripts/hostloop16_golden.rotation_case holds the JAX
    package's QuaternionManifold to it)."""
    rng = np.random.default_rng(23)
    q = np.array([0.9, 0.2, -0.3, 0.25])
    q /= np.linalg.norm(q)
    a = rng.standard_normal((20, 3))

    def rotate_np(q, a):
        t = 2.0 * np.cross(q[1:], a)
        return a + q[0] * t + np.cross(q[1:], t)

    b = np.array([rotate_np(q, ai) for ai in a]) + 0.01 * rng.standard_normal((20, 3))
    x = np.array([1.0, 0.1, -0.2, 0.3]) / np.linalg.norm([1.0, 0.1, -0.2, 0.3])

    def residual(q, ab):
        t = 2.0 * _cross(q[1:], ab[:3])
        return ab[:3] + q[0] * t + _cross(q[1:], t) - ab[3:]

    p = ctt.Problem()
    cost = ctt.AutoDiffCostFunction(residual, 3, [4])
    for ai, bi in zip(a, b):
        p.add_residual_block(cost, None, [x], data=np.concatenate([ai, bi]))
    p.set_manifold(x, ctt.AutoDiffManifold(_quaternion_plus, _quaternion_minus, 4, 3))
    return p, x


MANIFOLD_CASES = {"sphere": sphere_problem, "line": line_problem,
                  "quaternion": quaternion_problem}


def host_loop_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu):
    """Port slice 13's paths, the host trust-region loop on the card, each
    against the JAX host loop's answer (scripts/hostloop16_golden.py,
    HOSTLOOP16_GOLDEN, MANIFOLD_GOLDEN): (1) BAL-16 with fused_loop="NEVER",
    DENSE_SCHUR and ITERATIVE_SCHUR + SCHUR_JACOBI in both dtypes, CGNR +
    JACOBI in float64: float64 within 1e-6 in as many rows, float32 within
    1e-5 of its own dtype's, ITERATIVE_SCHUR <= GOLDEN_COST x (1 + 1e-4),
    a repeated solve bit for bit; the block steps launch rows 6, 7 and 9
    (and 4 on CGNR) every LM iteration; (2) BAL-16 DENSE_SCHUR ended by an IterationCallback at
    iteration 5 (SOLVER_TERMINATE_SUCCESSFULLY: USER_SUCCESS in 6 rows) and
    at 2 (SOLVER_ABORT: USER_FAILURE), with an EvaluationCallback counting
    its calls and update_state_every_iteration: the JAX messages and call
    counts, the problem's arrays holding each row's iterate; (3) both
    doglegs over ITERATIVE_SCHUR within 1e-6; (4) MGH 1-19 with DENSE_QR and
    DENSE_NORMAL_CHOLESKY under the default fused_loop (AUTO takes the host
    loop) on the card against the CPU; (5) the card against the CPU, the
    first HOST_CARD_VS_CPU_ITERATIONS rows of DENSE_SCHUR, ITERATIVE_SCHUR
    and traditional dogleg over ITERATIVE_SCHUR in float64; (7) the sphere,
    line and AutoDiff-quaternion fits on the card and the CPU, within 1e-9
    of the JAX answers. (Path 6, the Venice shape, is host_loop_venice.)
    Timings and busy shares of (1) and (3) against the fused loop's."""
    from ceres_tpu_torch.program import CompiledProgram

    DS = ctt.LinearSolverType.DENSE_SCHUR
    IS = ctt.LinearSolverType.ITERATIVE_SCHUR
    SJ = ctt.PreconditionerType.SCHUR_JACOBI

    def problem16():
        return bal.build_problem_batched(bal.bal16())[0]

    def gate_golden(path, s, dtn, golden_cost, golden_rows, extra=""):
        gap = (s.final_cost - golden_cost) / golden_cost
        paths[path]["gap_to_golden"] = gap
        limit = 1e-6 if dtn == "float64" else 1e-5
        check(s.termination_type == ctt.TerminationType.CONVERGENCE,
              f"{path}: did not converge: {s.message}")
        check(abs(gap) <= limit, f"{path}: final cost off the JAX host loop's by {gap:.3e}")
        if dtn == "float64":
            check(len(s.iterations) == golden_rows,
                  f"{path}: {len(s.iterations)} rows, the JAX host loop {golden_rows}")
        log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows "
            f"(JAX host loop {golden_cost!r} in {golden_rows}), relative gap {gap:.3e} "
            f"(limit {limit:.0e}){extra}; CG iterations "
            f"{[r.linear_solver_iterations for r in s.iterations]}; "
            f"{s.num_host_syncs} host syncs; {card}")
        return gap

    # -- (1) BAL-16 with fused_loop="NEVER" -----------------------------------------
    for path, kw, kernels in (
            ("bal16_host_dense_f64", dict(linear_solver_type=DS), HOST_PATH),
            ("bal16_host_dense_f32", dict(linear_solver_type=DS, evaluation_dtype="float32"),
             HOST_PATH),
            ("bal16_host_iterative_f64", dict(linear_solver_type=IS, preconditioner_type=SJ),
             HOST_PATH),
            ("bal16_host_iterative_f32", dict(linear_solver_type=IS, preconditioner_type=SJ,
                                              evaluation_dtype="float32"), HOST_PATH),
            ("bal16_host_cgnr_f64", dict(linear_solver_type=ctt.LinearSolverType.CGNR),
             ("normal_matvec",) + HOST_PATH)):
        dtn = kw.get("evaluation_dtype", "float64")
        opts = ctt.Options(fused_loop="NEVER", **kw)
        s, res = drive(path, opts, problem16(), kernels=kernels)
        gate_golden(path, s, dtn, *HOSTLOOP16_GOLDEN[path])
        # no sum of the block steps runs by atomics: a repeat is bit for bit
        again = ctt.solve(opts, problem16())
        res["repeat_bit_for_bit"] = ([r.cost for r in again.iterations]
                                     == [r.cost for r in s.iterations])
        check(res["repeat_bit_for_bit"], f"{path}: a repeated solve is not bit for bit "
              f"the first: {again.final_cost!r} against {s.final_cost!r}")
        if kw["linear_solver_type"] == IS:
            check(s.final_cost <= GOLDEN_COST * (1 + 1e-4),
                  f"{path}: final cost {s.final_cost} above golden x (1 + 1e-4)")
        if dtn == "float64":
            res["profile"] = profile_solve(lambda: ctt.solve(opts, problem16()),
                                           anchor=SEGMENT_SUM_ANCHOR, repeats=3)
            log(f"profile {path}", json.dumps(res["profile"]) + f"; {card}")

    # -- (2) the callbacks --------------------------------------------------------------
    class Counting(ctt.EvaluationCallback):
        def __init__(self):
            self.calls = 0

        def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
            self.calls += 1

    for ret, at, term in (("SOLVER_TERMINATE_SUCCESSFULLY", 5, "USER_SUCCESS"),
                          ("SOLVER_ABORT", 2, "USER_FAILURE")):
        path = "bal16_host_callbacks_" + term.lower()
        b = bal.bal16()
        problem, cams, pts = bal.build_problem_batched(b)
        seen = []

        def cb(it, ret=ret, at=at, seen=seen, cams=cams, pts=pts):
            seen.append((it.iteration, it.cost, it.step_is_successful,
                         cams.copy(), pts.copy()))
            if it.iteration == at:
                return ctt.CallbackReturnType[ret]
            return ctt.CallbackReturnType.SOLVER_CONTINUE

        ev = Counting()
        opts = ctt.Options(linear_solver_type=DS, callbacks=[cb], evaluation_callback=ev,
                           update_state_every_iteration=True)
        s, res = drive(path, opts, problem, kernels=HOST_PATH)
        cost, rows, message, calls = HOSTLOOP16_GOLDEN[ret]
        # each row's state: the problem's arrays at its callback, evaluated
        # anew on the card; a successful row's cost is the cost there, a
        # rejected row's arrays are the previous row's
        state_gaps = []
        for i, (n, c, ok, cam_i, pt_i) in enumerate(seen):
            if ok:
                prog = CompiledProgram(bal.build_problem_batched(bal.from_arrays(
                    cam_i, pt_i, b.camera_index, b.point_index, b.observations))[0],
                    device=dev)
                c_state = float(prog.evaluate_cost(prog.initial_state()))
                state_gaps.append(abs(c_state - c) / c)
            else:
                state_gaps.append(float(not (np.array_equal(cam_i, seen[i - 1][3])
                                             and np.array_equal(pt_i, seen[i - 1][4]))))
        gap = (s.final_cost - cost) / cost
        res.update(gap_to_golden=gap, evaluation_callback_calls=ev.calls,
                   state_gaps=state_gaps)
        log(f"solve {path}", f"{s.termination_type} in {len(s.iterations)} rows (JAX "
            f"{rows}), message {s.message!r}, final cost {s.final_cost!r} (JAX {cost!r}, "
            f"gap {gap:.3e}), EvaluationCallback calls {ev.calls} (JAX {calls}); per "
            f"callback, the cost of the problem's arrays against the row's (a rejected "
            f"row: 0 if its arrays are the last row's) {state_gaps}; {card}")
        check(s.termination_type.name == term and len(s.iterations) == rows
              and s.message == message, f"{path}: {s.termination_type}, "
              f"{len(s.iterations)} rows, {s.message!r}")
        check(ev.calls == calls == s.num_jacobian_evaluations,
              f"{path}: {ev.calls} evaluation callbacks, the JAX package's {calls}")
        check(abs(gap) <= 1e-6, f"{path}: final cost off the JAX package's by {gap:.3e}")
        check(len(seen) == rows and all(g <= 1e-9 for g in state_gaps),
              f"{path}: the problem's arrays are not the iterate: {state_gaps}")

    # -- (3) dogleg over ITERATIVE_SCHUR ------------------------------------------------
    def dogleg_opts(dogleg, **kw):
        return ctt.Options(linear_solver_type=IS, preconditioner_type=SJ,
                           trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
                           dogleg_type=ctt.DoglegType[dogleg], **kw)

    def dogleg_solver(opts, problem, device=None):
        return host_dogleg_solve(ctt, opts, problem, device)

    for dogleg, path in (("TRADITIONAL_DOGLEG", "bal16_host_dogleg_iterative_f64"),
                         ("SUBSPACE_DOGLEG", "bal16_host_subspace_dogleg_iterative_f64")):
        check(not dogleg_opts(dogleg).is_valid()[0],
              "Options.is_valid accepts DOGLEG with ITERATIVE_SCHUR")
        s, res = drive(path, dogleg_opts(dogleg), problem16(), kernels=HOST_PATH,
                       solver=dogleg_solver)
        gate_golden(path, s, "float64", *HOSTLOOP16_GOLDEN[dogleg])
        res["profile"] = profile_solve(lambda: dogleg_solver(dogleg_opts(dogleg), problem16()),
                                       anchor=SEGMENT_SUM_ANCHOR, repeats=3)
        log(f"profile {path}", json.dumps(res["profile"]) + f"; {card}")

    # -- (4) MGH under the default fused_loop: the host loop ------------------------------
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        mgh_card_vs_cpu(ctt, kn, dev, card, paths, "mgh_host_" + lst.lower(),
                        {"linear_solver_type": ctt.LinearSolverType[lst]}, MGH_MISSES)

    # -- (5) the card against the CPU -------------------------------------------------------
    ulp16 = bal.bal16()
    ulp16.cameras[...] = np.nextafter(ulp16.cameras, np.inf)

    def ulp_problem16():
        return bal.build_problem_batched(bal.from_arrays(
            ulp16.cameras, ulp16.points, ulp16.camera_index, ulp16.point_index,
            ulp16.observations))[0]

    n_cmp = HOST_CARD_VS_CPU_ITERATIONS
    card_against_cpu("bal16_host_dense_card_vs_cpu",
                     ctt.Options(fused_loop="NEVER", linear_solver_type=DS,
                                 max_num_iterations=n_cmp),
                     problem16, ulp_problem16, kernels=HOST_PATH)
    card_against_cpu("bal16_host_iterative_card_vs_cpu",
                     ctt.Options(fused_loop="NEVER", linear_solver_type=IS,
                                 preconditioner_type=SJ, max_num_iterations=n_cmp),
                     problem16, ulp_problem16, kernels=HOST_PATH)
    card_against_cpu("bal16_host_dogleg_iterative_card_vs_cpu",
                     dogleg_opts("TRADITIONAL_DOGLEG", max_num_iterations=n_cmp),
                     problem16, ulp_problem16, kernels=HOST_PATH, solver=dogleg_solver)

    # -- (7) the manifolds ---------------------------------------------------------------------
    for name, make in MANIFOLD_CASES.items():
        path = f"{name}_host_dense_qr"
        cost, rows, x_ref = MANIFOLD_GOLDEN[name]
        opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_QR)
        p_card, x_card = make(ctt)
        s, res = drive(path, opts, p_card, kernels=())
        p_cpu, x_cpu = make(ctt)
        s_cpu = ctt.solve(opts, p_cpu, device="cpu")
        gaps = [abs(a.cost - c.cost) / (abs(c.cost) or 1.0)  # a closing row holds 0
                for a, c in zip(s.iterations, s_cpu.iterations)]
        gap = abs(s.final_cost - cost) / cost
        x_gap = float(np.max(np.abs(x_card - np.asarray(x_ref))))
        res.update(gap_to_golden=gap, answer_gap=x_gap, relative_cost_gaps_to_cpu=gaps)
        log(f"solve {path}", f"{s.termination_type} in {len(s.iterations)} rows (JAX "
            f"{rows}; CPU {len(s_cpu.iterations)}), final cost {s.final_cost!r} (JAX "
            f"{cost!r}, gap {gap:.3e}), answer {x_card.tolist()} (largest gap to the JAX "
            f"answer {x_gap:.3e}), card against CPU per row {gaps}; {card}")
        check(s.termination_type == ctt.TerminationType.CONVERGENCE
              and len(s.iterations) == rows == len(s_cpu.iterations),
              f"{path}: {s.termination_type} in {len(s.iterations)} rows")
        check(gap <= 1e-9 and x_gap <= 1e-8, f"{path}: off the JAX answer: {gap}, {x_gap}")
        check(all(g <= 1e-9 for g in gaps), f"{path}: card and CPU rows differ: {gaps}")
        check(np.max(np.abs(x_card - x_cpu)) <= 1e-9, f"{path}: card and CPU answers differ")


def host_loop_venice(ctt, bal, card, paths, large_solves, problem_fn):
    """(6) The Venice shape, ITERATIVE_SCHUR + SCHUR_JACOBI in float32,
    HOST_VENICE_LM_ITERATIONS LM iterations through an IterationCallback
    that logs each row (the host loop's user at this scale; AUTO takes the
    host loop for it): costs finite and falling, a repeat bit for bit; ms
    per LM iteration, host syncs and the busy share beside the fused
    loop's venice_iterative_f32."""
    def log_row(it):
        log("venice host row", f"iteration {it.iteration}: cost {it.cost!r}, CG "
            f"iterations {it.linear_solver_iterations}, {it.iteration_time_in_seconds:.3f} "
            "s")
        return ctt.CallbackReturnType.SOLVER_CONTINUE

    path = "venice_host_iterative_f32"
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                       preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
                       evaluation_dtype="float32", callbacks=[log_row],
                       max_num_iterations=HOST_VENICE_LM_ITERATIONS)
    large_solves(path, opts, problem_fn, kernels=HOST_PATH)
    paths[path]["profile"] = profile_solve(lambda: ctt.solve(opts, problem_fn()),
                                           anchor=SEGMENT_SUM_ANCHOR, repeats=1)
    log(f"profile {path}", json.dumps(paths[path]["profile"]) + f"; {card}")


def mgh_card_vs_cpu(ctt, kn, dev, card, paths, path, over, misses_want):
    """MGH 1-19 under `over` on the card and on the CPU: the misses
    `misses_want`, the same verdicts, each 2 x final cost within 1e-8 of
    the CPU's (both under 1e-20 at a zero optimum; #16, whose crawl
    amplifies rounding tenfold every five rows (tests/test_torch_mgh.py):
    its first 40 rows to 1e-9 and its end within 5%), no kernel launched."""
    from ceres_tpu_torch.models import mgh

    lst = over["linear_solver_type"].name
    kn.reset_counts()
    t0 = time.monotonic()
    card_runs = {p.number: mgh.solve_problem(p, options_overrides=over, device=dev)
                 for p in mgh.PROBLEMS}
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    launches, plain_calls = counts(kn)
    t0 = time.monotonic()
    cpu_runs = {p.number: mgh.solve_problem(p, options_overrides=over, device="cpu")
                for p in mgh.PROBLEMS}
    cpu_s = time.monotonic() - t0
    misses = sorted(n for n, (ok, _, _) in card_runs.items() if not ok)
    gaps = {}
    for p in mgh.PROBLEMS:
        n = p.number
        ok, achieved, s = card_runs[n]
        ok_cpu, achieved_cpu, s_cpu = cpu_runs[n]
        check(ok == ok_cpu, f"{path} #{n}: card and CPU verdicts differ")
        check(s.linear_solver_type_used.name == lst,
              f"{path} #{n}: solved with {s.linear_solver_type_used}")
        if n == 16:
            rows = [abs(a.cost - b.cost) / abs(b.cost)
                    for a, b in zip(s.iterations[:40], s_cpu.iterations[:40])]
            gaps[n] = (max(rows), abs(achieved - achieved_cpu) / achieved_cpu)
            check(len(s.iterations) == len(s_cpu.iterations)
                  and gaps[n][0] <= 1e-9 and gaps[n][1] <= 5e-2,
                  f"{path} #16: card and CPU part: {gaps[n]}")
        elif ok and p.unconstrained_optimal_cost == 0.0:
            gaps[n] = (achieved, achieved_cpu)
            check(achieved < 1e-20 and achieved_cpu < 1e-20,
                  f"{path} #{n}: 2 * final cost {achieved} (CPU {achieved_cpu}) "
                  f"not under 1e-20")
        else:
            gaps[n] = abs(achieved - achieved_cpu) / abs(achieved_cpu)
            check(gaps[n] <= 1e-8, f"{path} #{n}: card and CPU 2 * final costs "
                  f"{achieved!r}, {achieved_cpu!r} differ by {gaps[n]:.3e}")
    rows = sum(len(s.iterations) for _, _, s in card_runs.values())
    syncs = sum(s.num_host_syncs for _, _, s in card_runs.values())
    paths[path] = {"iterations": rows - len(card_runs), "misses": misses,
                   "achieved": {n: a for n, (_, a, _) in card_runs.items()},
                   "card_vs_cpu": gaps, "card_s": card_s, "cpu_s": cpu_s,
                   "host_syncs": syncs, "launches": launches,
                   "plain_calls": plain_calls}
    log(f"solve {path}", f"misses {misses} (want {list(misses_want)}); 2 * final cost "
        f"by problem {json.dumps(paths[path]['achieved'])}; card against CPU (relative "
        f"gap; for a zero optimum both values; for #16 the first 40 rows' largest and "
        f"the end's) {json.dumps(gaps)}; {rows} summary rows, {syncs} host syncs in "
        f"{card_s:.1f} s on the card ({1e3 * card_s / max(rows, 1):.3f} ms a row), "
        f"{cpu_s:.1f} s on the CPU; {card}")
    check(misses == list(misses_want), f"{path}: misses {misses}")
    check(all(v == 0 for v in launches.values()) and all(
        v == 0 for v in plain_calls.values()), f"{path}: a kernel ran: {launches}")


def modeling_phase(ctt, bal, libmv, kn, dev, card, paths, drive, check_and_time,
                   kernel_inputs, b16, lp16, rng):
    """The modeling API's paths on the card, each against the JAX package's
    answer (scripts/modeling16_golden.py, MODELING16_GOLDEN; float64 within
    1e-6, float32 within 1e-5 of its own dtype's): (a) BAL-16 built one
    block at a time with camera 0 constant, DENSE_SCHUR and ITERATIVE_SCHUR
    in both dtypes, the jt path with the sentinel camera; (b) BAL-16 with a
    box on the points, DENSE_SCHUR in both dtypes: every point inside the
    box, the float64 answer with as many coordinates on a bound as the JAX
    one; (c) evaluation_dtype="mixed", DENSE_SCHUR and ITERATIVE_SCHUR;
    (d) use_mixed_precision_solves, DENSE_SCHUR (the flat path); (e)
    libmv16 with constant intrinsics, DENSE_SCHUR and ITERATIVE_SCHUR (the
    flat path, the constant family in no plan); (f) the user ordering
    [[points], [cameras]], the rows of the default ordering bit for bit;
    (g) the nine constrained MGH problems with DENSE_QR,
    DENSE_NORMAL_CHOLESKY and that with mixed solves, on the card and the
    CPU. (a), (b) and (e) also on the CPU for MODELING_CARD_VS_CPU_ITERATIONS
    rows: the same rows, each cost within 1e-9. First, rows 1, 2, 3, 3b, 4
    and 4b at gauge-fixed BAL-16's first-iteration inputs, and rows 6, 7
    and 9 at its camera slot's flat plan (the sentinel key), against their
    plain versions, timed. Also the per-block build's time beside the
    batched one's."""
    from ceres_tpu_torch.models import mgh
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solver import _pick_linear_solver
    from ceres_tpu_torch.solvers.fused_lm import FlatDenseSchurStepOps
    from ceres_tpu_torch.summary import Summary

    DS = ctt.LinearSolverType.DENSE_SCHUR
    IS = ctt.LinearSolverType.ITERATIVE_SCHUR
    SJ = ctt.PreconditionerType.SCHUR_JACOBI

    # -- the per-block build of BAL-16 beside the batched one ---------------------
    t0 = time.monotonic()
    gauge16 = gauge_fixed_problem(bal, b16)[0]
    t_block = time.monotonic() - t0
    t0 = time.monotonic()
    CompiledProgram(gauge16, device=dev)
    t_block_compile = time.monotonic() - t0
    t0 = time.monotonic()
    batched16 = bal.build_problem_batched(bal.from_arrays(
        b16.cameras, b16.points, b16.camera_index, b16.point_index, b16.observations))[0]
    t_batched = time.monotonic() - t0
    t0 = time.monotonic()
    CompiledProgram(batched16, device=dev)
    t_batched_compile = time.monotonic() - t0
    log("build bal16", f"one block at a time: {gauge16.num_residual_blocks()} residual "
        f"blocks in {t_block:.3f} s, compiled in {t_block_compile:.3f} s; batched: "
        f"{t_batched:.4f} s, compiled in {t_batched_compile:.3f} s (host); {card}")
    del gauge16, batched16

    # -- rows 1-4b at the sentinel camera, 6, 7 and 9 at the sentinel key ---------
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(gauge_fixed_problem(bal, b16)[0], dtn, device=dev)
        opts = ctt.Options(linear_solver_type=DS)
        args = kernel_inputs(prog, opts, True, rng)
        plan = args["post_eval_fused"][2]
        check(plan.n_cams == plan.C + 1 and int((plan.cam_pos < 0).sum()) > 0,
              "gauge-fixed BAL-16: no sentinel camera in the row plan")
        check_and_time("bal16_gauge", dtn, {k: args[k] for k in (
            "eval_fused", "post_eval_fused", "schur_assembly", "normal_matvec",
            "isc_matvec", "schur_jacobi_blocks")}, 100, 10)
        _, e_fams = _pick_linear_solver(opts, prog, Summary())
        ops = FlatDenseSchurStepOps(prog, opts, e_fams)
        fl = ops.flat
        pcam = fl.plans_f[0][0]
        _, vrep = ops.evaluate(prog.initial_state())
        g, sqn, aux = ops.post_eval(vrep)
        contrib = fl.post_contrib(fl._jac(vrep.vflat, 0, pcam), fl._rows(vrep.r, 0))
        local = pcam.local.cpu().numpy()
        order = np.argsort(local, kind="stable")
        srt = fo.build_segment_plan(local[order], pcam.nv + 1, dev)
        scale_c = (1.0 / (1.0 + torch.sqrt(sqn.to(torch.float64)))).to(prog.compute_dtype)
        sf = pt.extract_f(ops.pm, scale_c)[:pcam.nv * pcam.t].reshape(pcam.nv, pcam.t)
        table = torch.cat([sf, sf.new_zeros((1, pcam.t))])
        check(int((pcam.local == pcam.nv).sum()) > 0,
              "gauge-fixed BAL-16: no sentinel key in the camera slot's plan")
        check_and_time("bal16_gauge", dtn, {
            "unsorted_segment_sum_sentinel": (contrib, pcam.seg),
            "segment_block_sum_sentinel": (
                contrib[torch.as_tensor(order, device=dev)].contiguous(), srt),
            "segment_block_expand_sentinel": (table, pcam.local)}, 100, 10)
        del prog, args, ops, vrep, aux, contrib
        gc.collect()
        torch.cuda.empty_cache()

    def gate(path, s, dtn, extra=""):
        golden, rows = MODELING16_GOLDEN[path]
        gap = (s.final_cost - golden) / golden
        limit = 1e-6 if dtn == "float64" else 1e-5
        paths[path]["gap_to_golden"] = gap
        check(s.termination_type == ctt.TerminationType.CONVERGENCE,
              f"{path}: did not converge: {s.message}")
        check(abs(gap) <= limit, f"{path}: final cost off the JAX package's by {gap:.3e}")
        log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows "
            f"(the JAX package's: {golden!r} in {rows}), relative gap {gap:.3e} (limit "
            f"{limit:.0e}); {paths[path]['host_syncs']} host syncs; "
            f"{paths[path]['ms_per_iteration']:.3f} ms per LM iteration{extra}; {card}")

    def card_vs_cpu(path, opts, problem_fn, **kw):
        """The same solve cut to MODELING_CARD_VS_CPU_ITERATIONS rows on the
        card (through drive) and the CPU: the same rows and CG counts, each
        cost within 1e-9."""
        opts = dataclasses.replace(opts, max_num_iterations=MODELING_CARD_VS_CPU_ITERATIONS)
        s_card, _ = drive(path, opts, problem_fn(), **kw)
        t0 = time.monotonic()
        s_cpu = ctt.solve(opts, problem_fn(), device="cpu")
        cpu_s = time.monotonic() - t0
        rows_card = [(r.linear_solver_iterations, r.cost) for r in s_card.iterations]
        rows_cpu = [(r.linear_solver_iterations, r.cost) for r in s_cpu.iterations]
        gaps = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(rows_card, rows_cpu)]
        paths[path].update(cpu_rows=rows_cpu, relative_cost_gaps_to_cpu=gaps, cpu_s=cpu_s)
        log(f"{path}", f"card rows {rows_card}; cpu rows {rows_cpu} ({cpu_s:.1f} s); "
            f"relative cost gap per row {', '.join(f'{g:.3e}' for g in gaps)} (limit "
            f"1e-9); {card}")
        check(len(rows_card) == len(rows_cpu)
              and [a[0] for a in rows_card] == [b[0] for b in rows_cpu],
              f"{path}: card and CPU rows or CG counts differ")
        check(all(g <= 1e-9 for g in gaps), f"{path}: card and CPU costs differ: {gaps}")

    # -- (a) gauge-fixed BAL-16, built one block at a time --------------------------
    for lst, name in ((DS, "dense"), (IS, "iterative")):
        for dtn in ("float64", "float32"):
            path = f"bal16_gauge_{name}_{TAG[dtn]}"
            s, _ = drive(path, ctt.Options(linear_solver_type=lst, preconditioner_type=SJ,
                                           evaluation_dtype=dtn),
                         gauge_fixed_problem(bal, b16)[0])
            gate(path, s, dtn, f"; {s.num_effective_parameters_reduced} tangent "
                 f"coordinates")
    card_vs_cpu("bal16_gauge_dense_f64_card_vs_cpu", ctt.Options(linear_solver_type=DS),
                lambda: gauge_fixed_problem(bal, b16)[0])

    # -- (b) box-bounded BAL-16 ----------------------------------------------------
    lo, hi = (np.percentile(b16.points, q, axis=0) for q in BOX_PERCENTILES)
    clipped = float(np.mean((b16.points < lo) | (b16.points > hi)))

    def bounded_problem():
        p, _, pts = bal.build_problem_batched(bal.from_arrays(
            b16.cameras, b16.points, b16.camera_index, b16.point_index, b16.observations))
        p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo,
                                           upper=hi)
        return p, pts

    for dtn in ("float64", "float32"):
        path = f"bal16_bounds_dense_{TAG[dtn]}"
        p, pts = bounded_problem()
        s, res = drive(path, ctt.Options(
            linear_solver_type=DS, evaluation_dtype=dtn,
            **(BOX_F32_TO_CONVERGENCE if dtn == "float32" else {})), p)
        inside = bool(np.all((pts >= lo) & (pts <= hi)))
        on = int(np.sum((pts == lo) | (pts == hi)))
        res.update(inside_box=inside, on_bound=on, clipped_at_start=clipped,
                   is_constrained=s.is_constrained)
        gate(path, s, dtn, f"; start clipped {clipped:.4f} of the point coordinates, "
             f"answer on a bound {on} (the JAX package's {BOUNDS16_ON_BOUND[dtn]}), every "
             f"point inside the box {inside}")
        check(inside and s.is_constrained, f"{path}: a point left its box")
        check(dtn == "float32" or on == BOUNDS16_ON_BOUND[dtn],
              f"{path}: {on} coordinates on a bound, the JAX package {BOUNDS16_ON_BOUND[dtn]}")
    card_vs_cpu("bal16_bounds_dense_f64_card_vs_cpu", ctt.Options(linear_solver_type=DS),
                lambda: bounded_problem()[0])

    # -- (c) evaluation_dtype="mixed" ---------------------------------------------
    for lst, name in ((DS, "dense"), (IS, "iterative")):
        path = f"bal16_mixed_{name}"
        s, res = drive(path, ctt.Options(linear_solver_type=lst, preconditioner_type=SJ,
                                         evaluation_dtype="mixed"),
                       bal.build_problem_batched(bal.bal16())[0], extra_evaluations=1)
        res["phases"] = re.findall(r"\((\d+) its\)", s.message)
        gate(path, s, "float64", f"; {s.message[:60]}")

    # -- (d) mixed-precision solves: the flat dense-Schur step ------------------------
    path = "bal16_mixed_solves_dense_f64"
    s, _ = drive(path, ctt.Options(linear_solver_type=DS, use_mixed_precision_solves=True),
                 bal.build_problem_batched(bal.bal16())[0], flat=True)
    gate(path, s, "float64")

    # -- (e) libmv16 with constant intrinsics ------------------------------------------
    for lst, name in ((DS, "dense"), (IS, "iterative")):
        path = f"libmv16_const_intrinsics_{name}_f64"
        problem, _, _, intr = libmv.build_problem(fresh(lp16), refine_intrinsics=False)
        before = intr.copy()
        s, _ = drive(path, ctt.Options(linear_solver_type=lst, preconditioner_type=SJ),
                     problem, flat=True)
        gate(path, s, "float64", f"; structure {s.schur_structure_used}")
        check(np.array_equal(intr, before), f"{path}: the constant intrinsics moved")
    card_vs_cpu("libmv16_const_intrinsics_dense_f64_card_vs_cpu",
                ctt.Options(linear_solver_type=DS),
                lambda: libmv.build_problem(fresh(lp16), refine_intrinsics=False)[0],
                flat=True)

    # -- (f) the user ordering -----------------------------------------------------
    path = "bal16_ordering_dense_f64"
    p = bal.build_problem_batched(bal.bal16())[0]
    arrays = p.parameter_block_arrays()
    s, _ = drive(path, ctt.Options(linear_solver_type=DS,
                                   linear_solver_ordering=[[arrays[1]], [arrays[0]]]), p)
    default = ctt.solve(ctt.Options(linear_solver_type=DS),
                        bal.build_problem_batched(bal.bal16())[0])
    same = [r.cost for r in s.iterations] == [r.cost for r in default.iterations]
    gate(path, s, "float64", f"; the rows of the default ordering bit for bit {same}")
    check(same, f"{path}: the rows differ from the default ordering's")

    # -- (g) the constrained MGH problems, on the card and the CPU --------------------
    for config, golden in MGH_CONSTRAINED_GOLDEN.items():
        lst = config.split("_mixed")[0]
        over = {"linear_solver_type": ctt.LinearSolverType[lst], "fused_loop": "ALWAYS",
                "use_mixed_precision_solves": config.endswith("_mixed")}
        path = "mgh_constrained_" + config.lower()
        kn.reset_counts()
        t0 = time.monotonic()
        card_runs = {n: mgh.solve_problem(next(p for p in mgh.PROBLEMS if p.number == n),
                                          True, options_overrides=over, device=dev)
                     for n in golden}
        torch.cuda.synchronize()
        card_s = time.monotonic() - t0
        launches, plain_calls = counts(kn)
        cpu_runs = {n: mgh.solve_problem(next(p for p in mgh.PROBLEMS if p.number == n),
                                         True, options_overrides=over, device="cpu")
                    for n in golden}
        gaps = {}
        for n, want in golden.items():
            ok, achieved, s = card_runs[n]
            ok_cpu, achieved_cpu, _ = cpu_runs[n]
            gaps[n] = (abs(achieved - want) / want if want else achieved,
                       abs(achieved - achieved_cpu) / abs(achieved_cpu)
                       if achieved_cpu else achieved)
            check(ok and ok_cpu and s.is_constrained, f"{path} #{n}: not solved")
            check(gaps[n][0] <= 1e-8 and gaps[n][1] <= 1e-8,
                  f"{path} #{n}: 2 * final cost {achieved!r} against the JAX package's "
                  f"{want!r} and the CPU's {achieved_cpu!r}")
        rows = sum(len(s.iterations) for _, _, s in card_runs.values())
        paths[path] = {"achieved": {n: a for n, (_, a, _) in card_runs.items()},
                       "gaps_to_golden_and_cpu": gaps, "card_s": card_s,
                       "summary_rows": rows, "launches": launches,
                       "plain_calls": plain_calls}
        log(f"solve {path}", f"all nine solved; relative gaps to the JAX package's 2 * "
            f"final cost and to the CPU's by problem (for a zero optimum the value) "
            f"{json.dumps(gaps)}; {rows} summary rows in {card_s:.1f} s on the card; {card}")
        check(all(v == 0 for v in launches.values()) and all(
            v == 0 for v in plain_calls.values()), f"{path}: a kernel ran: {launches}")


def robust_problem(bal, b, model, loss):
    """A problem of BAL arrays b (copied: a solve writes into them) with
    `loss` on every observation, angle-axis or quaternion cameras."""
    arrays = bal.from_arrays(b.cameras, b.points, b.camera_index, b.point_index,
                             b.observations)
    if model == "quat":
        return bal.build_problem_batched_quat(arrays, loss)[0]
    return bal.build_problem_batched(arrays, loss)[0]


def eval_args(prog):
    """eval_fused's arguments at the program's initial state, as its jt
    step passes them: (cams, pts, obs, plan, rows_fn, loss chain)."""
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.solver import _pick_linear_solver
    from ceres_tpu_torch.solvers.fused_lm import IterativeSchurStepOps
    from ceres_tpu_torch.summary import Summary

    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR)
    _, e_fams = _pick_linear_solver(opts, prog, Summary())
    ops = IterativeSchurStepOps(prog, opts, e_fams)
    q, dt, x0 = ops._jt_qual, prog.compute_dtype, prog.initial_state()
    return (prog.family_table(x0, q.fam_f).to(dt).contiguous(),
            prog.family_table(x0, q.fam_e).to(dt).contiguous(),
            prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss)


def cg_counts(ctt, kn, path, res, s, opts, problem):
    """A record, not a gate: the CG iterations per LM iteration of an
    ITERATIVE_SCHUR solve `s`, and in float32 those of the same solve with
    isc_matvec's plain version on the card (its index_add_ sums by
    atomics, so that solve may differ from run to run) and of the solve on
    the CPU (the plain versions throughout), whose rounding differs from
    the kernel's. A float32 CG near its forcing tolerance is sensitive to
    rounding (PERF.md §7); this shows which path a kernel change moved."""
    runs = {"kernel": s}
    if opts.evaluation_dtype == "float32":
        kernel = kn.isc_matvec
        kn.isc_matvec = kn.isc_matvec_plain
        try:
            runs["plain_on_card"] = ctt.solve(opts, problem())
        finally:
            kn.isc_matvec = kernel
        runs["cpu"] = ctt.solve(opts, problem(), device="cpu")
    for name, run in runs.items():
        cg = [r.linear_solver_iterations for r in run.iterations]
        res[f"cg_iterations_{name}"] = cg
        log(f"cg {path}", f"{name}: {sum(cg)} CG iterations in {len(cg)} rows, "
            f"{sum(c >= opts.max_linear_solver_iterations for c in cg)} at the limit; "
            f"final cost {run.final_cost!r}; per row {cg}")
    if opts.evaluation_dtype == "float32":
        cg_divergence(ctt, kn, path, res, runs, opts, problem)


# the JAX package's float32 BAL-16 + HuberLoss(1.0) ITERATIVE_SCHUR solve,
# CG iterations per row: scripts/robust16_golden.py's problem and options
# with evaluation_dtype="float32", JAX on a CPU (NO_CONVERGENCE after 30
# LM iterations, final cost 43747.765625); a record beside the port's
JAX_ROBUST16_ITERATIVE_F32_CG = [0, 2, 2, 3, 5, 5, 5, 5, 2, 12, 2, 2, 2, 2, 2, 2, 2, 2,
                                 2, 2, 4, 8, 11, 12, 13, 18, 19, 19, 20, 2, 20]


def cg_divergence(ctt, kn, path, res, runs, opts, problem):
    """A record, not a gate: where the kernel path's float32 CG counts part
    from those of isc_matvec's plain version on the card and on the CPU
    (side by side, the JAX package's beside them), and how symmetric the
    float32 Schur operator S is at the first row where the kernel path's
    count leaves the plain version's on the card: |z1'S z2 - z2'S z1| /
    (|z1| |S z2|) on isc_matvec's inputs of that row's CG (recorded from a
    repeat of the kernel solve, which repeats bit for bit), through the
    kernel, its plain version in float32 and its plain version in float64,
    for the row's first two nonzero CG vectors and for two random vectors.
    A less symmetric S breaks CG's conjugacy."""
    cg = {k: [r.linear_solver_iterations for r in v.iterations] for k, v in runs.items()}
    cg["jax"] = JAX_ROBUST16_ITERATIVE_F32_CG

    def first_apart(other):
        return next((i for i, (a, b) in enumerate(zip(cg["kernel"], cg[other]))
                     if a != b), None)

    first = {k: first_apart(k) for k in cg if k != "kernel"}
    n = max(map(len, cg.values()))
    table = [[i] + [cg[k][i] if i < len(cg[k]) else None for k in cg] for i in range(n)]
    res["cg_side_by_side"] = {"columns": ["row"] + list(cg), "rows": table}
    res["cg_first_row_apart"] = first
    log(f"cg {path}", f"per row ({', '.join(['row'] + list(cg))}): {table}; JAX "
        f"{sum(cg['jax'])} in {len(cg['jax'])} rows; the first row where the kernel "
        f"path's count differs, from each: {first}")
    row = first["plain_on_card"]
    if not row:
        return
    # isc_matvec's inputs of each linear solve: schur_jacobi_blocks runs
    # once at the start of each, so solve k is row k + 1
    solves, kernel, jacobi = [], kn.isc_matvec, kn.schur_jacobi_blocks

    def jacobi_rec(*args):
        solves.append({"z": []})
        return jacobi(*args)

    def isc_rec(JT, z, minv, plan, emit_u=False):
        rec = solves[-1]
        if not rec["z"]:
            rec.update(JT=JT, minv=minv, plan=plan)
        if len(rec["z"]) < 2 and bool(torch.any(z != 0)):  # not x0 = 0
            rec["z"].append(z.clone())
        return kernel(JT, z, minv, plan, emit_u)

    # a wrapper counts on the module's name of it, here the recorder's
    for rec_fn in (isc_rec, jacobi_rec):
        rec_fn.launches = rec_fn.plain_calls = 0
    kn.isc_matvec, kn.schur_jacobi_blocks = isc_rec, jacobi_rec
    try:
        again = ctt.solve(opts, problem())
    finally:
        kn.isc_matvec, kn.schur_jacobi_blocks = kernel, jacobi
    check([r.linear_solver_iterations for r in again.iterations] == cg["kernel"]
          and len(solves) == len(cg["kernel"]) - 1,
          f"{path}: the recorded repeat of the kernel solve differs")
    rec = solves[row - 1]
    # a point block that is not positive definite in float32 leaves M^{-1}
    # non-finite, and the row's CG runs to its limit: a record of the inputs
    nonfinite = {k: int((~torch.isfinite(rec[k])).sum()) for k in ("JT", "minv")}
    res["nonfinite_inputs_at_first_row_apart"] = {"row": row, **nonfinite}
    log(f"cg {path}", f"row {row}: non-finite entries of isc_matvec's inputs {nonfinite}")
    gen = torch.Generator(device=rec["JT"].device).manual_seed(5)
    pairs = {"random": [torch.randn(rec["z"][0].shape, generator=gen, device=gen.device,
                                    dtype=torch.float64) for _ in range(2)]}
    if len(rec["z"]) == 2:
        pairs["cg_directions"] = rec["z"]
    fns = {"kernel": (kernel, torch.float32),
           "plain_f32": (kn.isc_matvec_plain, torch.float32),
           "plain_f64": (kn.isc_matvec_plain, torch.float64)}
    sym = {}
    for pname, (z1, z2) in pairs.items():
        for fname, (fn, dt) in fns.items():
            JT, minv = rec["JT"].to(dt), rec["minv"].to(dt)
            s1 = fn(JT, z1.to(dt).contiguous(), minv, rec["plan"])[0].double()
            s2 = fn(JT, z2.to(dt).contiguous(), minv, rec["plan"])[0].double()
            a = float(torch.sum(z1.double() * s2))
            b = float(torch.sum(z2.double() * s1))
            sym[f"{pname}_{fname}"] = abs(a - b) / float(z1.double().norm() * s2.norm())
    res["schur_asymmetry_at_first_row_apart"] = {"row": row, **sym}
    log(f"cg {path}", f"row {row}, the kernel path's first CG count apart from the "
        f"plain version's on the card: |z1'S z2 - z2'S z1| / (|z1| |S z2|) "
        + ", ".join(f"{k} {v:.3e}" for k, v in sym.items()))


def robust_phase(ctt, bal, kn, dev, card, b16, paths, check_and_time, drive):
    """Robust-loss and quaternion-camera BA (bundle_adjuster.cc --robustify,
    --use_quaternions --use_manifolds) on BAL-16: eval_fused with each of
    the nine losses in both camera models and both dtypes against its
    plain version; rows 1L (angle-axis + Huber) and 1Q (quaternion + Huber)
    timed; the solves of BAL-16 + HuberLoss(1.0) (DENSE_SCHUR and
    ITERATIVE_SCHUR) and of quaternion BAL-16 + HuberLoss(1.0) (DENSE_SCHUR)
    in both dtypes against scripts/robust16_golden.py, with the launches of
    their eval_fused variant exact; their ms per LM iteration; a 6-camera
    quaternion + CauchyLoss(0.5) solve on the card against the CPU."""
    from ceres_tpu_torch.program import CompiledProgram

    DS, IS = ctt.LinearSolverType.DENSE_SCHUR, ctt.LinearSolverType.ITERATIVE_SCHUR
    for dtn in ("float64", "float32"):
        args = {}
        for model in ("angle_axis", "quat"):
            for name, make in ROBUST_LOSSES.items():
                prog = CompiledProgram(robust_problem(bal, b16, model, make(ctt)), dtn,
                                       device=dev)
                args[f"eval_fused_{model}_{name}"] = eval_args(prog)
        check_and_time("bal16", dtn, args, 0, 0, timed=False)
        check_and_time("bal16", dtn, {"eval_fused_loss": args["eval_fused_angle_axis_huber"],
                                      "eval_fused_quat": args["eval_fused_quat_huber"]},
                       100, 10)
        del args, prog

    configs = [("bal16_huber", "angle_axis", "dense", DS),
               ("bal16_huber", "angle_axis", "iterative", IS),
               ("bal16_quat_huber", "quat", "dense", DS)]
    for tag, model, solver, lst in configs:
        variant = "eval_fused_quat" if model == "quat" else "eval_fused_loss"
        golden, golden_rows = ROBUST16_GOLDEN[(tag, solver)]
        extra = ({} if solver == "dense" else
                 dict(max_num_iterations=30, max_linear_solver_iterations=100,
                      preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI))
        for dtn in ("float64", "float32"):
            path = f"{tag}_{solver}_{TAG[dtn]}"
            opts = ctt.Options(linear_solver_type=lst, evaluation_dtype=dtn, **extra)

            def problem():
                return robust_problem(bal, b16, model, ctt.HuberLoss(1.0))

            s, res = drive(path, opts, problem(), variant=variant)
            gap = (s.final_cost - golden) / golden
            res["gap_to_golden"] = gap
            check(s.is_solution_usable(), f"{path}: solution not usable: {s.message}")
            if dtn == "float64" and solver == "dense":
                check(s.termination_type == ctt.TerminationType.CONVERGENCE,
                      f"{path}: did not converge")
                check(abs(gap) <= 1e-6, f"{path}: final cost off golden by {gap:.3e}")
                limit = "|gap| <= 1e-6"
            elif dtn == "float64":
                check(s.final_cost <= golden * (1 + 1e-4),
                      f"{path}: final cost {s.final_cost} above golden x (1 + 1e-4)")
                limit = "<= golden x (1 + 1e-4)"
            else:
                check(s.final_cost <= golden * (1 + ROBUST_F32_REL),
                      f"{path}: final cost {s.final_cost} above golden x "
                      f"(1 + {ROBUST_F32_REL})")
                limit = f"<= golden x (1 + {ROBUST_F32_REL})"
            per_it = [res["ms_per_iteration"]]
            for _ in range(2):
                s2 = ctt.solve(opts, problem())
                torch.cuda.synchronize()
                per_it.append(1e3 * s2.minimizer_time_in_seconds / (len(s2.iterations) - 1))
            res["ms_per_iteration_runs"] = per_it
            res["ms_per_iteration_median"] = statistics.median(per_it)
            if solver == "iterative":
                cg_counts(ctt, kn, path, res, s, opts, problem)
            log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows "
                f"(JAX golden {golden!r} in {golden_rows}), relative gap {gap:.3e} "
                f"(gate: {limit}); {variant} launches {res['launches'][variant]}; ms per "
                f"LM iteration over 3 solves: median {res['ms_per_iteration_median']:.4f}, "
                "runs " + ", ".join(f"{v:.4f}" for v in per_it) + f"; {card}")

    # the card against the CPU: 6 cameras, quaternion + CauchyLoss(0.5)
    small = bal.perturb(bal.synthetic_bal(num_cameras=6, num_points=80, visibility=0.4,
                                          seed=0), 0.02, 0.1, 0.1, seed=1)
    opts = ctt.Options(linear_solver_type=DS, fused_loop="ALWAYS")  # AUTO: the host loop
    s_card, _ = drive("quat_cauchy_c6_card_vs_cpu", opts,
                      robust_problem(bal, small, "quat", ctt.CauchyLoss(0.5)),
                      variant="eval_fused_quat")
    s_cpu = ctt.solve(opts, robust_problem(bal, small, "quat", ctt.CauchyLoss(0.5)),
                      device="cpu")
    rows_card = [r.cost for r in s_card.iterations]
    rows_cpu = [r.cost for r in s_cpu.iterations]
    gaps = [abs(a - b) / abs(b) for a, b in zip(rows_card, rows_cpu)]
    log("quat_cauchy_c6 card vs cpu", f"rows {len(rows_card)} (cpu {len(rows_cpu)}); "
        f"relative cost gap per row {', '.join(f'{g:.3e}' for g in gaps)} (limit 1e-9); "
        f"{card}")
    paths["quat_cauchy_c6_card_vs_cpu"]["relative_cost_gaps_to_cpu"] = gaps
    check(len(rows_card) == len(rows_cpu) and all(g <= 1e-9 for g in gaps),
          f"quaternion + Cauchy: card and CPU rows differ: {gaps}")
    gc.collect()
    torch.cuda.empty_cache()


def specialized_phase(dev, card, b16, paths, check_and_time):
    """The specialized pipeline (parallel/sharded_ba.py; the JAX package's
    bench.py:131) on BAL-16: kernel 8J against its plain version at the
    first iteration's inputs; v1 and v2 in float64 against the JAX
    package's costs and in float32 (also with PRECISE_SCHUR_SOLVE), one
    k = 20 call of each driven with exact launch counts and no host sync
    inside; their times; v1 on the card against the CPU."""
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.ops import kernels as kn
    from ceres_tpu_torch.parallel import sharded_ba as sb

    K = SPECIALIZED_K
    golden = SPECIALIZED16_GOLDEN

    def spec_setup(b, dt, device=dev, asm=False):
        """BAL-16's rows sorted by point (bench.py:136-146 without the
        TPU's balanced point order), their plan, the start state."""
        ci, pi, obs = sb.observations_by_point(b.camera_index, b.point_index,
                                               b.observations, dt, device)
        build_plan = sb.build_asm_plan if asm else sb.build_point_plan
        plan = build_plan(ci, pi, b.num_points, b.num_cameras, device)
        return sb.state_from_arrays(b.cameras, b.points, 1e4, dt, device), ci, pi, obs, plan

    def v1_call(setup):
        _, ci, pi, obs, plan = setup
        return lambda st, k: sb.lm_step_schur_k(st.cams, st.pts, ci, pi, obs, st.radius,
                                                k=k, plan=plan)

    def v2_call(setup):
        _, ci, pi, obs, plan = setup
        obs_T = obs.T.contiguous()
        return lambda st, k: sb.lm_step_schur_v2_k(st.cams, st.pts, ci, pi, obs_T,
                                                   st.radius, plan, k=k)

    def drive_k(path, pipeline, run, start):
        """One k-call with the counts set to 0 just before it and read just
        after, under torch.cuda.set_sync_debug_mode("error"): a host sync
        inside the call raises. The cost read after it is the call's one
        sync. Exact launch counts (specialized_launches). Then a call of
        one iteration behind queued device work, which must outlast it."""
        torch.cuda.synchronize()
        kn.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            st = run(start, K)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cost = float(st.cost)
        wall_s = time.perf_counter() - t0
        launches, plain_calls = counts(kn)
        want = specialized_launches(pipeline, K)
        peak = torch.cuda.max_memory_allocated()

        def behind_queued_work(k):
            """(returned before ~3 s of device work queued ahead of it ended,
            host seconds) of a k-call: the call returns first only if nothing
            in it waited for the device, and if its launches fit the launch
            queue (the k = 20 call's ~6,600 do not: the host then blocks
            until the queue drains)."""
            torch.cuda._sleep(int(2e9 * 3))
            ahead = torch.cuda.Event()
            ahead.record()
            t1 = time.perf_counter()
            run(start, k)
            host_s = time.perf_counter() - t1
            returned_ahead = not ahead.query()
            torch.cuda.synchronize()
            return returned_ahead, host_s

        # the same without the prototype sync detector, on one iteration:
        # every iteration runs the same code, with no branch on device values
        queued = {k: behind_queued_work(k) for k in (1, K)}
        res = {"iterations": K, "final_cost": cost, "radius": float(st.radius),
               "wall_s": wall_s, "peak_device_bytes": peak,
               "launches": launches, "plain_calls": plain_calls,
               "expected_launches": want,
               "behind_queued_work_by_k": {k: {"returned_ahead": a, "host_s": h}
                                           for k, (a, h) in queued.items()}}
        log(f"pipeline {path}", json.dumps(res) + f"; {card}")
        check(all(v == 0 for v in plain_calls.values()),
              f"{path}: a plain version ran on the card")
        check(all(launches[k] == want.get(k, 0) for k in launches),
              f"{path}: launches {launches}, expected exactly {want}")
        check(queued[1][0], f"{path}: a call of one iteration waited for the device")
        paths[path] = res
        return st, res

    def spec_times(path, run, start):
        """ms per LM iteration as bench.py:177-178 reads it: the wall time
        of 4 chained calls of k = 20 over 80, median of 5; the time to the
        first iteration (tensors, plan, one iteration: kernels built); the
        device busy share: the device time of one k-call under
        torch.profiler over the median's wall time of k iterations."""
        per_it = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = start
            for _ in range(4):
                st = run(st, K)
            float(st.cost)
            per_it.append(1e3 * (time.perf_counter() - t0) / (4 * K))
        res = paths[path]
        res["ms_per_iteration_runs"] = per_it
        res["ms_per_iteration_median"] = statistics.median(per_it)
        res["profile"] = profile_k_call(lambda: run(start, K), K,
                                        res["ms_per_iteration_median"])
        log("time", f"pipeline {path}: ms per LM iteration (4 calls of k=20 / 80) over "
            f"5: median {res['ms_per_iteration_median']:.4f}, runs "
            + ", ".join(f"{v:.4f}" for v in per_it) + "; device busy share "
            f"{res['profile'].get('device_busy_share')}; peak device memory "
            f"{res['peak_device_bytes'] / 2**30:.3f} GiB; time to first iteration "
            f"{res['time_to_first_iteration_s']:.3f} s; profile "
            f"{json.dumps(res['profile'])}; {card}")

    for dtn in ("float64", "float32"):
        args = {}
        for pipeline, call in (("v1", v1_call), ("v2", v2_call)):
            setup = spec_setup(b16, getattr(torch, dtn), asm=pipeline == "v2")
            args.update({c: a for c, a in first_iteration_args(
                pipeline, call(setup), setup[0]).items() if c not in args})
        check_and_time("bal16_specialized", dtn, args, 100, 10)
        del args, setup

    for dtn in ("float64", "float32"):
        dt = getattr(torch, dtn)
        for pipeline, call in (("v1", v1_call), ("v2", v2_call)):
            path = f"specialized_{pipeline}_{TAG[dtn]}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            setup = spec_setup(b16, dt, asm=pipeline == "v2")
            run = call(setup)
            first = float(run(setup[0], 1).cost)
            ttfi = time.perf_counter() - t0
            start = setup[0]
            # four calls of k = 5, against the JAX package's costs (and warm-up)
            costs, st = [], start
            for _ in range(4):
                st = run(st, 5)
                costs.append(float(st.cost))
            st, res = drive_k(path, pipeline, run, start)
            res.update(time_to_first_iteration_s=ttfi, first_iteration_cost=first,
                       costs_after_5_10_15_20=costs)
            gaps = [(c - g) / g for c, g in zip(costs + [res["final_cost"]],
                                                 golden + golden[-1:])]
            res["gaps_to_jax"] = gaps
            if dtn == "float64":
                log(f"pipeline {path}", f"costs after 5/10/15/20 {costs}, one k={K} call "
                    f"{res['final_cost']!r}; relative gaps to the JAX package's "
                    f"{list(golden)}: {', '.join(f'{g:.3e}' for g in gaps)} (limit 1e-6)")
                check(all(abs(g) <= 1e-6 for g in gaps),
                      f"{path}: off the JAX package's costs: {gaps}")
            else:
                log(f"pipeline {path}", f"costs after 5/10/15/20 {costs}, one k={K} call "
                    f"{res['final_cost']!r} (the JAX package's float32 run on the CPU: "
                    f"{SPECIALIZED16_JAX_F32} from iteration 5 on); gate: finite, "
                    f"non-increasing, <= 1.05 x {golden[-1]}")
                check(all(np.isfinite(c) for c in costs)
                      and all(b <= a for a, b in zip(costs, costs[1:]))
                      and costs[-1] <= 1.05 * golden[-1]
                      and res["final_cost"] <= 1.05 * golden[-1],
                      f"{path}: float32 costs {costs}, {res['final_cost']}")
            spec_times(path, run, start)
            del setup, run, st
    sb.PRECISE_SCHUR_SOLVE = True
    try:
        setup = spec_setup(b16, torch.float32)
        cost = float(v1_call(setup)(setup[0], K).cost)
    finally:
        sb.PRECISE_SCHUR_SOLVE = False
    paths["specialized_v1_f32"]["precise_schur_solve_final_cost"] = cost
    log("pipeline specialized_v1_f32", f"with PRECISE_SCHUR_SOLVE: {cost!r} after {K} "
        f"LM iterations (gate <= {golden[-1]} x (1 + 1e-4)); {card}")
    check(cost <= golden[-1] * (1 + 1e-4),
          f"specialized v1 float32 with PRECISE_SCHUR_SOLVE ends at {cost}")
    del setup

    # the card against the CPU: lm_step_schur_k (k = 10) with the plan, float64
    small = bal.perturb(bal.synthetic_bal(num_cameras=6, num_points=400,
                                          visibility=0.5, seed=5),
                        0.01, 0.05, 0.05, seed=1)
    ulp = bal.from_arrays(np.nextafter(small.cameras, np.inf), small.points,
                          small.camera_index, small.point_index, small.observations)
    runs = {}
    for name, b, device in (("card", small, dev), ("cpu", small, "cpu"),
                            ("cpu_ulp", ulp, "cpu")):
        setup = spec_setup(b, torch.float64, device)
        runs[name] = v1_call(setup)(setup[0], 10)
    vs_cpu = {}
    for field in ("cams", "pts", "cost"):
        ref = getattr(runs["cpu"], field)
        scale = ref.abs().max().item()
        gap = (getattr(runs["card"], field).cpu() - ref).abs().max().item() / scale
        sens = (getattr(runs["cpu_ulp"], field) - ref).abs().max().item() / scale
        vs_cpu[field] = {"gap": gap, "cpu_one_ulp_sensitivity": sens,
                         "limit": max(1e-9, 4 * sens)}
    log("pipeline specialized card vs cpu", f"6 cameras, 400 points, k=10: "
        f"{json.dumps(vs_cpu)}; card cost {float(runs['card'].cost)!r}, cpu "
        f"{float(runs['cpu'].cost)!r}; {card}")
    paths["specialized_v1_f64"]["card_vs_cpu"] = vs_cpu
    check(all(v["gap"] <= v["limit"] for v in vs_cpu.values()),
          f"specialized v1: card and CPU differ: {vs_cpu}")
    del runs, setup
    gc.collect()
    torch.cuda.empty_cache()


# the one PyTorch call that computes each flat-path kernel's function
LIBRARY_CALL = {
    "segment_block_sum": "Tensor.index_add on a zero table",
    "unsorted_segment_sum": "Tensor.index_add on a zero table",
    "segment_block_expand": "torch.index_select",
    "segment_spread_sum": "Tensor.index_put(accumulate=True) on a zero (P, C, te, tf) "
                          "table, without the permute to (P, te, C, tf)",
}


def library_call(name, args):
    """A zero-argument function making that one call on the case's inputs
    (its index tensors made beforehand), or None."""
    if name in ("segment_block_sum", "unsorted_segment_sum"):
        contrib, plan = args
        zero = contrib.new_zeros((plan.num_keys, contrib.shape[1]))
        return lambda: zero.index_add(0, plan.ids, contrib)
    if name == "segment_block_expand":
        vals, ids = args
        return lambda: torch.index_select(vals, 0, ids)
    if name == "segment_spread_sum":
        Y, cam, pt_start, C, te, tf = args
        P = pt_start.shape[0] - 1
        n = int(pt_start[-1])
        pt = torch.repeat_interleave(torch.arange(P, device=Y.device),
                                     pt_start[1:] - pt_start[:-1])
        index = (pt, torch.clamp(cam[:n].long(), max=C))
        zero = Y.new_zeros((P, C + 1, te, tf))
        values = Y[:n].reshape(n, te, tf)
        return lambda: zero.index_put(index, values, accumulate=True)
    return None


def profile_solve(run, anchor=("eval_fused_kernel",), repeats=3):
    """Device busy share of one solve: the sum of the device time of the
    CUDA events of the minimizer in a solve under torch.profiler (from the
    first launch of a kernel whose name holds one of `anchor` on: the
    set-up's copies to the card come before; on the flat path the anchor,
    its first segment sum, comes after the first plain evaluation) over the
    median minimizer wall time of `repeats` solves of the same
    configuration without the profiler, which slows the host; also the
    share of the profiled solve's own minimizer wall time, which reads
    low."""
    walls = []
    for _ in range(repeats):
        s = run()
        torch.cuda.synchronize()
        walls.append(1e3 * s.minimizer_time_in_seconds)
    s, _, busy_us, n_ops, by_name = device_profile(run, anchor)
    n_it = len(s.iterations) - 1
    wall_ms = statistics.median(walls)
    profiled_ms = 1e3 * s.minimizer_time_in_seconds
    res = {"minimizer_ms": wall_ms, "unprofiled_minimizer_ms_runs": walls,
           "profiled_minimizer_ms": profiled_ms, "iterations": n_it,
           "cg_iterations": sum(r.linear_solver_iterations for r in s.iterations)}
    res = busy_share(res, busy_us, n_ops, by_name, wall_ms, n_it)
    if busy_us > 0:
        res["device_busy_share_of_profiled_wall"] = busy_us / 1e3 / profiled_ms
    return res


def profile_k_call(run, k, ms_per_iteration):
    """Device busy share of one k-call of the specialized pipeline: the
    device time of all its CUDA events in a call under torch.profiler over
    the wall time of k iterations without it (ms_per_iteration, measured
    before: the profiler slows the host); also the share of the profiled
    call's own wall time (host clock, to the cost's one sync)."""
    _, wall_s, busy_us, n_ops, by_name = device_profile(lambda: float(run().cost))
    res = {"profiled_wall_ms": 1e3 * wall_s, "unprofiled_wall_ms": ms_per_iteration * k,
           "iterations": k}
    res = busy_share(res, busy_us, n_ops, by_name, ms_per_iteration * k, k)
    if busy_us > 0:
        res["device_busy_share_of_profiled_wall"] = busy_us / 1e3 / (1e3 * wall_s)
    return res


def device_profile(run, anchor=None):
    """(run's result, its wall seconds, device microseconds, device ops,
    device microseconds by kernel name) of one run under torch.profiler
    after a warm one; with `anchor`, only the CUDA events from the first
    launch of a kernel whose name holds one of its names on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_us, n_ops, by_name = 0.0, 0, {}
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    t0 = min((e.time_range.start for e in dev_events
              if anchor is None or any(a in e.name for a in anchor)), default=0)
    for evt in dev_events:
        if evt.time_range.start >= t0:
            busy_us += evt.device_time_total
            n_ops += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time_total
    return out, wall_s, busy_us, n_ops, by_name


# the kernels of the point-block rows (csrc/point_blocks.cuh), named by
# their body: the pad, the point pass and the camera levels of each, and
# schur_assembly's pair chunks and pair levels; and those of the segment sums
# (csrc/segment_sum.cu), named by their entry point's tag: row 6's tile pass
# and levels, row 9's gather and levels
ROW_KERNEL_TAGS = {"isc_matvec": "IscMatvec", "normal_matvec": "NormalMatvec",
                   "post_eval_fused": "PostEvalFused",
                   "schur_jacobi_blocks": "SchurJacobi",
                   "schur_assembly": "SchurAssembly",
                   "segment_block_sum": "SegmentBlockSum",
                   "unsorted_segment_sum": "UnsortedSegmentSum"}
# the first kernel a flat-path solve's minimizer launches is a segment sum's
SEGMENT_SUM_ANCHOR = ("SegmentBlockSum", "UnsortedSegmentSum")


def log_row_passes(path, profile, card):
    for name, ms in profile.get("row_device_ms_per_iteration", {}).items():
        log(f"profile {path}", f"{name}'s kernels: {ms['total']} device ms per LM "
            f"iteration, by pass {json.dumps(ms['by_kernel'])}; {card}")


def kernel_label(name):
    """A device kernel's name without its arguments and namespaces."""
    return (name.replace("(anonymous namespace)::", "").replace("void ", "")
            .replace("ct::", "").split("(")[0])


def row_device_ms(by_name, n_it):
    """Device ms per LM iteration of each row's kernels (ROW_KERNEL_TAGS), in
    all and by kernel (its name without its arguments and namespaces)."""
    out = {}
    for row, tag in ROW_KERNEL_TAGS.items():
        passes = {}
        for k, us in by_name.items():
            if re.search(rf"\b{tag}\b", k):
                label = kernel_label(k)
                passes[label] = passes.get(label, 0.0) + us / 1e3 / max(n_it, 1)
        if passes:
            out[row] = {"total": sum(passes.values()), "by_kernel": passes}
    return out


def busy_share(res, busy_us, n_ops, by_name, wall_ms, n_it):
    """res with the busy share and the top kernels per iteration added."""
    if busy_us > 0:
        # names cut to 80 characters, the device time of names that share
        # those summed (PyTorch's elementwise kernels differ only later)
        top = {}
        for k, v in by_name.items():
            top[k[:80]] = top.get(k[:80], 0.0) + v / 1e3 / max(n_it, 1)
        res.update(device_busy_ms=busy_us / 1e3,
                   device_busy_share=busy_us / 1e3 / wall_ms,
                   row_device_ms_per_iteration=row_device_ms(by_name, n_it),
                   device_ops_per_iteration=n_ops / max(n_it, 1),
                   top_device_ms_per_iteration=dict(
                       sorted(top.items(), key=lambda kv: -kv[1])[:10]))
    else:
        res["device_busy_share"] = "not measured"
    return res


def work(case, args):
    """(bytes, flops) that the function itself needs on these inputs: each
    input read once and each output written once, where the inputs are the
    tensors and the row -> camera / point / block maps (cam_idx, pt_idx,
    a segment plan's ids), not the design's own plans or workspaces; and
    the arithmetic, taking each symmetric product once."""
    name = CASES[case]
    if name in ("segment_block_sum", "unsorted_segment_sum"):
        contrib, plan = args
        out = contrib.element_size() * plan.num_keys * contrib.shape[1]
        return nbytes(contrib, plan.ids) + out, contrib.numel()  # one add per value
    if name == "segment_block_expand":
        vals, ids = args
        return nbytes(vals, ids) + vals.element_size() * ids.numel() * vals.shape[1], 0
    if name == "segment_spread_ftf":
        Y, cam, pt_start, C, te, tf, Jc, r = args[:8]
        P = pt_start.shape[0] - 1
        es = Y.element_size()
        # Y, Jc, the row -> camera and row -> point maps, A (P, te*C*tf) and
        # F'F (C, tf*tf); an add per Y value, the r products of each of the
        # tf(tf+1)/2 entries of a row's symmetric outer product, multiply-add
        byts = nbytes(Y, Jc, cam) + 4 * Y.shape[0] + es * (P * te * C * tf + C * tf * tf)
        return byts, Y.numel() + Y.shape[0] * r * tf * (tf + 1)
    if name == "segment_spread_sum":
        Y, cam, pt_start, C, te, tf = args
        P = pt_start.shape[0] - 1
        # Y, the row -> camera and row -> point maps, the (P, te*C*tf) A
        return nbytes(Y, cam) + 4 * Y.shape[0] + Y.element_size() * P * te * C * tf, Y.numel()
    plan = next(a for a in args if hasattr(a, "cam_idx"))
    B, P, C = plan.B, plan.P, plan.C
    idx = nbytes(plan.cam_idx, plan.pt_idx)
    if name in EVAL_VARIANTS:
        cams, pts, obs = args[:3]
        loss = args[5] if len(args) > 5 else None
        es = cams.element_size()
        byts = nbytes(cams, pts, obs) + idx + es * 26 * B + 8
        # per row: the rotation with its 3 tangent derivatives, projection, J
        # (angle-axis ~330, quaternion ~300); with a loss, rho and the
        # corrector on the 24 lanes (~140)
        ops = 330 if cams.shape[1] == 9 else 300
        return byts, (ops + (140 if loss is not None and loss.ops else 0)) * B
    if name == "post_eval_fused":
        JT, rT = args[:2]
        es = JT.element_size()
        byts = nbytes(JT, rT) + idx + es * (15 * P + 18 * C)
        # g_e, sqn_e, E'E (6 of 9), g_f, sqn_f per row
        return byts, (12 + 12 + 24 + 36 + 36) * B
    if name == "schur_assembly":
        JT, sc, sp, K, u = args[:5]
        es = JT.element_size()
        byts = nbytes(JT, sc, sp, K, u) + idx + es * ((9 * C) ** 2 + 81 * C + 9 * C)
        # ordered pairs of a point's rows of variable cameras, a == b too (a
        # constant camera's rows, the sentinel, form no pair)
        m = torch.zeros(P, dtype=torch.long, device=plan.pt_idx.device).index_add_(
            0, plan.pt_idx.long(), (plan.cam_idx < C).long())
        NP = int(torch.sum(m * m))
        # per row: scaling 24, W 108, Y 162, FtF (45 of 81) 180, U 54;
        # Y_a'Y_b once per unordered pair a != b, 45 of 81 entries for a == b
        return byts, 528 * B + 486 * (NP - B) // 2 + 270 * B
    if name == "isc_matvec":
        JT, z, minv = args[:3]
        emit_u = args[4]
        es = JT.element_size()
        byts = nbytes(JT, z, minv) + idx + es * (9 * C + (3 * P if emit_u else 0))
        # per row: F z 36, E'fz 12, E u 12, q 2, F'q 36; per point M^{-1} e 15
        return byts, 98 * B + 15 * P
    if name == "schur_jacobi_blocks":
        JT, se, minv = args[:3]
        es = JT.element_size()
        byts = nbytes(JT, se, minv) + idx + es * 81 * C
        # per row: W 81 + scale 27, Y = M^{-1} W 135, and on the 45 entries
        # of the upper triangle J_f'J_f 135, W'Y 225, the difference and
        # the sum 90
        return byts, 693 * B
    JT, xc, xp = args[:3]
    es = JT.element_size()
    byts = nbytes(JT, xc, xp) + idx + es * (9 * C + 3 * P)
    return byts, 96 * B  # jv, J_f'jv, J_e'jv per row


if __name__ == "__main__":
    sys.exit(main())
