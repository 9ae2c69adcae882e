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
plain versions and timed at the sentinel inputs. And the sparse direct
solvers (sparse_phase) in the host loop, against the JAX package's answers
(scripts/sparse16_golden.py): BAL-16 SPARSE_SCHUR in both dtypes,
SPARSE_NORMAL_CHOLESKY (the default options, dynamic sparsity,
mixed-precision solves), BAL-16 built per block with CGNR + SUBSET, 3D and
2D pose graphs of 2,500 and 3,500 poses; libmv16 and the 2,048-camera
instance with SPARSE_SCHUR on the card against the CPU; rows 6 and 7 held
against their plain versions and timed at the assembly's inputs; each run's
host factorization time, bytes from the device, Cholesky tier and a repeat
bit for bit. And the preconditioners and Schur options of ITERATIVE_SCHUR
(precond_phase, precond_venice): BAL-16 with SCHUR_POWER_SERIES_EXPANSION,
the power series' initial guess, CLUSTER_JACOBI under both clusterings,
CLUSTER_TRIDIAGONAL and the explicit S in the fused and the host loop, in
both dtypes, against the JAX package's answers
(scripts/precond16_golden.py); the 2,048-camera instance with both cluster
preconditioners and the host loop's explicit S on the card against the
CPU, and the fused explicit S on the card; float32 SPSE at the Venice
shape; rows 6 and 7 held against their plain versions and timed at the
cluster assembly's and the CSR product's inputs; the clustering's host
seconds, clusters and largest cluster. And the example scripts of
ceres_tpu_torch/examples/ (examples_phase): each through its main(argv) on
the card against the JAX script's answer with the same arguments
(scripts/examples_golden.py), bundle_adjuster.py at BAL-16's shape under
SPARSE_SCHUR, DENSE_SCHUR, ITERATIVE_SCHUR and DENSE_SCHUR with
--robustify and libmv_bundle_adjuster.py on libmv16 written to a file,
each launching the kernels of its path, and one full_report.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase mesh --cards 4

The second builds the kernels and runs only the mesh phase (port slices
19 and 20): the tiers on card 0 as the first runs them, then the NCCL
group of 4 ranks, one per card, at world sizes 4, 2 and 1 (--cards 2:
2 and 1), and BAL-16 DENSE_SCHUR solved on cuda:1 in this process; it
needs that many cards. Exits nonzero on any failure, and before printing
any result when no CUDA device is available. Its last line is {"ok": true, "device": {...}}; the
line before it lists every ported TPU kernel with its launches, error and
times. Imports nothing of jax and nothing of ceres_tpu.
"""
import copy
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
# chip machine's host. Cut again to 6 beside the sparse phase (port slice
# 14), whose card-against-CPU solves take ~1.5 min of the host, and to 4
# beside the precond phase (port slice 15), to 2 beside the line-search
# phase (port slice 16), and to 1 beside the mesh phase (port slice 19)
LIBMV16_CARD_VS_CPU_ITERATIONS = 1
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
# CPU solves of libmv16 take 1-2 s an LM iteration on the card's host (cut
# from 15 and 10 beside the sparse phase, from 8 and 6 beside the precond
# phase, and from 4 and 3 beside the mesh phase)
CGNR16_CARD_VS_CPU_ITERATIONS = 2
LIBMV16_CGNR_CARD_VS_CPU_ITERATIONS = 2
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
# DENSE_SCHUR LM iteration takes seconds on the card's host (4 until the
# mesh phase came)
MODELING_CARD_VS_CPU_ITERATIONS = 2
# the MGH problems that miss the optimum at trial 0, in both packages: #2
# stops at the local minimum 48.98, #16 crawls (tests/test_mgh.py:10-17);
# the JAX host loop misses the same two (scripts/hostloop16_golden.py d)
MGH_MISSES = (2, 16)
# MGH #16 crawls for 1,001 rows and amplifies rounding tenfold every five:
# its card-against-CPU runs stop at this many iterations (1,000 until the
# line-search phase came; they held only its first 40 rows and its end)
MGH16_CARD_VS_CPU_ITERATIONS = 40
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
HOST_CARD_VS_CPU_ITERATIONS = 2  # 15 until the sparse phase came, 8 until the precond,
# 4 until the mesh phase
# the Venice shape in the host loop: LM iterations of each solve
HOST_VENICE_LM_ITERATIONS = 3
# the kernels of the host loop's block steps (solvers/bsr_kernels.py): the
# flat products gather by row 7 and sum by 6 (point ids) and 9 (camera
# ids); DENSE_SCHUR also sums the blocks of W and F'F by 6
HOST_PATH = ("segment_block_sum", "segment_block_expand", "unsorted_segment_sum")
# scripts/sparse16_golden.py: the JAX package's answers with the sparse
# direct solvers, (final cost, summary rows), in its host loop: (a) BAL-16
# SPARSE_SCHUR; (b) SPARSE_NORMAL_CHOLESKY, default options, then dynamic
# sparsity (DYNAMIC16_ITERATIONS iterations) and mixed-precision solves (3
# refinements, 25 iterations);
# (c) BAL-16 built per block, CGNR + SUBSET (SUBSET_DROP_MIN), eta 1e-2,
# 35 iterations; (d) the pose graphs (POSE3D, POSE2D), default options
SPARSE16_GOLDEN = {
    "bal16_sparse_schur_f64": (51931.10068031217, 17),
    "bal16_sparse_schur_f32": (51931.09765625, 17),
    "bal16_snc_f64": (51931.10068031216, 17),
    "bal16_snc_dynamic_f64": (61805.86030703291, 4),
    "bal16_snc_mixed_f64": (51931.10068029502, 17),
    "bal16_cgnr_subset_f64": (51931.14122680712, 17),
    "pose3d_2500_snc_f64": (44.61189345024491, 21),
    "pose2d_3500_snc_f64": (62.524154392499554, 16),
}
# the JAX CG counts of (c), a record beside the port's (CG counts follow
# rounding)
JAX_SUBSET16_CG = [0, 3, 5, 3, 3, 3, 2, 3, 3, 3, 3, 2, 2, 2, 2, 3, 4]
# dynamic sparsity analyzes J'J's 66,462 columns anew at every step (~4 s on
# the chip machine's host): its run is cut to this many LM iterations, and
# not repeated (its assembly is SPARSE_NORMAL_CHOLESKY's, whose repeat is)
DYNAMIC16_ITERATIONS = 3
# the pose graphs: (poses, loop closures, noise, seed, max_num_iterations):
# sphere2500's pose count in 3D, M3500's in 2D (pose_graph.synthetic_*)
POSE3D = (2500, 250, 0.01, 0, 20)
POSE2D = (3500, 350, 0.02, 0, 50)
# SUBSET leaves one observation of each point seen at least this often out
# of the preconditioner's rows (tests/test_bal_golden.py:104-143)
SUBSET_DROP_MIN = 6
# libmv16 SPARSE_SCHUR on the card against the CPU: its first rows (6 until
# the precond phase came, 3 until the mesh phase)
LIBMV16_SPARSE_CARD_VS_CPU_ITERATIONS = 1
# 2,048-camera SPARSE_SCHUR on the card against the CPU (5 until the precond
# phase came: its CPU solves factor an 18,432-column S, ~2 s a step)
SPARSE_C2048_LM_ITERATIONS = 1
# the sparse steps' flat products and their assembly of J'J or S: rows 6, 7
# and 9; CGNR + SUBSET's matvec on a BAL program adds row 4
SPARSE_PATH = HOST_PATH
# scripts/precond16_golden.py: the JAX package's answers on BAL-16 with the
# preconditioners and Schur options of ITERATIVE_SCHUR (default options
# otherwise), (final cost, summary rows) per (path, loop, dtype): the JAX
# fused loop ("ALWAYS") and host loop ("NEVER"); its host loop cannot run
# the explicit S in float32 (a float64 S in a float32 CG loop), so that
# path's float32 run is held to the float64 golden
PRECOND16_GOLDEN = {
    ("spse", "ALWAYS", "float64"): (51935.9798404648, 30),
    ("spse", "ALWAYS", "float32"): (51936.015625, 30),
    ("spse", "NEVER", "float64"): (51935.979840464825, 30),
    ("spse", "NEVER", "float32"): (51935.9765625, 30),
    ("spse_init", "ALWAYS", "float64"): (51931.15049740099, 29),
    ("spse_init", "ALWAYS", "float32"): (51931.15625, 29),
    ("spse_init", "NEVER", "float64"): (51931.15049740099, 29),
    ("spse_init", "NEVER", "float32"): (51931.09765625, 30),
    ("cj_cv", "ALWAYS", "float64"): (51931.10068031214, 17),
    ("cj_cv", "ALWAYS", "float32"): (51931.140625, 19),
    ("cj_cv", "NEVER", "float64"): (51931.10068031217, 17),
    ("cj_cv", "NEVER", "float32"): (51931.1015625, 17),
    ("cj_sl", "ALWAYS", "float64"): (51931.87165466735, 22),
    ("cj_sl", "ALWAYS", "float32"): (51931.875, 22),
    ("cj_sl", "NEVER", "float64"): (51931.87165466735, 22),
    ("cj_sl", "NEVER", "float32"): (51931.87890625, 22),
    ("ct", "ALWAYS", "float64"): (51931.10068031214, 17),
    ("ct", "ALWAYS", "float32"): (51931.140625, 19),
    ("ct", "NEVER", "float64"): (51931.10068031217, 17),
    ("ct", "NEVER", "float32"): (51931.1015625, 17),
    ("explicit", "ALWAYS", "float64"): (51931.87165466735, 22),
    ("explicit", "ALWAYS", "float32"): (51931.8828125, 22),
    ("explicit", "NEVER", "float64"): (51931.87165466737, 22),
    ("explicit", "NEVER", "float32"): (51931.87165466737, 22),
}
# the options of each path of PRECOND16_GOLDEN (scripts/precond16_golden.py)
PRECOND_PATHS = {
    "spse": dict(preconditioner_type="SCHUR_POWER_SERIES_EXPANSION"),
    "spse_init": dict(preconditioner_type="SCHUR_JACOBI", use_spse_initialization=True),
    "cj_cv": dict(preconditioner_type="CLUSTER_JACOBI"),
    "cj_sl": dict(preconditioner_type="CLUSTER_JACOBI",
                  visibility_clustering_type="SINGLE_LINKAGE"),
    "ct": dict(preconditioner_type="CLUSTER_TRIDIAGONAL"),
    "explicit": dict(use_explicit_schur_complement=True),
}
# the precond phase's runs at 2,048 cameras and the Venice shape, and its
# 2,048-camera runs on the card against the CPU, whose CPU solves take
# 5-15 s an LM iteration on the chip machine's host (a batched Cholesky of
# 13 blocks of up to 2,961 columns; 13 chain positions for the tridiagonal);
# the card against the CPU cut to 1 LM iteration each beside the line-search
# phase (port slice 16)
PRECOND_LARGE_LM_ITERATIONS = 3
PRECOND_CARD_VS_CPU_LM_ITERATIONS = {"cj_cv": 1, "ct": 1, "explicit": 1}
# scripts/linesearch16_golden.py: the JAX package's answers on port slice
# 16's paths, (termination, final cost, summary rows' costs, (probes,) or
# (inner steps,)): (a) LINE_SEARCH on BAL-16 (each stops at its first
# iteration: BAL-16's gradient max norm is 2.3e9) and on C120, LBFGS +
# WOLFE fused (AUTO) and host (NEVER), nonlinear CG + ARMIJO fused, to
# LS16_DEPTH iterations; (b) BAL-16 DENSE_SCHUR with inner iterations,
# fused float32 and host float64, 25 iterations; (c) the sparse phase's
# pose graphs with inner iterations in the host loop, INNER_POSE_DEPTH
# iterations
LS16_DEPTH = {"float64": 50, "float32": 8}
INNER_POSE_DEPTH = 8
LINESEARCH16_GOLDEN = {
    ('bal16', 'lbfgs', 'AUTO', 'float64'): ('NO_CONVERGENCE', 19012078.580987826, [19012078.580987822], (3,)),
    ('bal16', 'lbfgs', 'NEVER', 'float64'): ('CONVERGENCE', 19012078.580987826, [19012078.580987822], (2,)),
    ('bal16', 'ncg_armijo', 'AUTO', 'float64'): ('NO_CONVERGENCE', 19012078.580987826, [19012078.580987822], (3,)),
    ('bal16', 'lbfgs', 'AUTO', 'float32'): ('NO_CONVERGENCE', 19012080.0, [19012078.0], (3,)),
    ('bal16', 'lbfgs', 'NEVER', 'float32'): ('CONVERGENCE', 19012080.0, [19012078.0], (2,)),
    ('bal16', 'ncg_armijo', 'AUTO', 'float32'): ('NO_CONVERGENCE', 19012080.0, [19012078.0], (3,)),
    ('c120', 'lbfgs', 'AUTO', 'float64'): ('NO_CONVERGENCE', 7558.463481863795, [169236.22607061584, 125393.40680106007, 103381.09885365612, 80925.97248877022, 66712.08118448686, 60193.16812622499, 57801.92300738161, 55070.58348220715, 52002.94594965664, 48684.87759075179, 45257.00713236689, 41552.294935381855, 37727.41542342949, 33716.24459049161, 29567.035833514074, 25614.24888459585, 21482.34039187654, 18592.665529549653, 17591.700839440575, 16381.442608140263, 15687.922960390926, 14928.466477653985, 14251.662149161828, 13437.68884089123, 12573.169553461199, 11745.235912017613, 10886.119508542812, 10545.055067994881, 9998.721753321928, 9810.615132096193, 9616.044122823823, 9411.750570674849, 9199.322265664126, 9046.952723126115, 8847.94297392841, 8702.352844013914, 8556.612486221102, 8404.302827360127, 8297.39814973667, 8182.414606502791, 8110.402614776973, 8044.642239672835, 7971.46719633762, 7896.147815677315, 7842.584030673315, 7789.018290308062, 7731.735073334845, 7672.88325353061, 7632.14131492242, 7587.891546678349, 7558.463481863796], (52,)),
    ('c120', 'lbfgs', 'NEVER', 'float64'): ('NO_CONVERGENCE', 7558.4613523884045, [169236.22607061584, 125393.40665661165, 103381.09885263568, 80925.97279200063, 66712.08029360355, 60193.168857605204, 57801.92300685922, 55070.582690089315, 52002.94407561531, 48684.87440796662, 45257.0027351466, 41552.28907464372, 37727.40804166852, 33716.23575491837, 29567.025456024458, 25614.238261240025, 21482.32939744931, 18592.658508091572, 17591.698434849925, 16381.44098243177, 15687.921067223037, 14928.464227896524, 14251.660073814404, 13437.686342533441, 12573.166149342262, 11745.233529961339, 10886.117069859858, 10545.046853799247, 9998.718023890804, 9810.610804656182, 9616.03970780595, 9411.745633813563, 9199.317332024071, 9046.948310649637, 8847.939198958826, 8702.350851410665, 8556.611219620445, 8404.302928107887, 8297.397072556812, 8182.414083108969, 8110.401232685056, 8044.6412760708645, 7971.464690572354, 7896.146408308419, 7842.5804271516945, 7789.016009693594, 7731.733174434326, 7672.882332409326, 7632.137522567893, 7587.889644048197, 7558.461352388405], (51,)),
    ('c120', 'ncg_armijo', 'AUTO', 'float64'): ('NO_CONVERGENCE', 15506.489248163769, [169236.22607061584, 125393.40680106007, 100288.13256135253, 85516.51569224514, 74501.21408630858, 68223.72180990406, 65473.75180699624, 63286.22191771304, 59427.02893614873, 55548.06416668503, 51975.905974173445, 48578.8454815499, 45805.20781651385, 44566.51385741522, 43262.74371058482, 41715.135178009725, 39806.124018608505, 37718.73710612367, 35772.29919981648, 34343.753831424045, 33540.608310498945, 32315.796944928938, 30833.687757944746, 29242.603001487405, 27604.247547281815, 25947.773626375743, 24286.16392579881, 22683.886934007336, 21453.12691312471, 21065.38601451807, 20703.295028210734, 20394.812275666118, 20217.724438844347, 20054.97808993775, 19775.730341027815, 19454.304462050604, 19109.883811161635, 18748.02229276301, 18371.405720364048, 17982.30849206538, 17583.323199736253, 17177.704011749527, 16770.77104740924, 16376.123617294059, 16040.9250280527, 15905.61664445121, 15841.440000204748, 15772.255226754827, 15695.601194309409, 15608.242598172717, 15506.489248163769], (61,)),
    ('c120', 'lbfgs', 'AUTO', 'float32'): ('NO_CONVERGENCE', 52002.9140625, [169236.25, 125393.3984375, 103381.09375, 80925.984375, 66712.0625, 60193.17578125, 57801.91015625, 55070.55859375, 52002.9140625], (10,)),
    ('c120', 'lbfgs', 'NEVER', 'float32'): ('NO_CONVERGENCE', 52002.91015625, [169236.25, 125393.3984375, 103381.09375, 80925.9765625, 66712.0625, 60193.1796875, 57801.91015625, 55070.55859375, 52002.91015625], (9,)),
    ('c120', 'ncg_armijo', 'AUTO', 'float32'): ('NO_CONVERGENCE', 59427.19921875, [169236.25, 125393.3984375, 100288.171875, 85516.578125, 74501.2421875, 68223.7109375, 65473.76953125, 63286.30859375, 59427.19921875], (13,)),
    ('inner_dense_schur', 'ALWAYS', 'float32'): ('CONVERGENCE', 51931.15234375, [19012080.0, 56666.9921875, 52849.87890625, 52163.66015625, 52089.125, 52068.0625, 52108.79296875, 52109.33984375, 52109.21875, 52111.86328125, 52074.93359375, 52007.0390625, 51947.2421875, 51932.55859375, 51931.328125, 51931.22265625, 51931.15234375, 51931.1015625], (0,)),
    ('inner_dense_schur', 'NEVER', 'float64'): ('CONVERGENCE', 51931.09471504023, [19012078.580987826, 56981.49577472825, 52835.301466211706, 52156.68981154297, 52104.65263531323, 52043.75282394704, 51960.361461361594, 51931.09471504023, 0.0], (7,)),
    ('pose3d', 'inner'): ('NO_CONVERGENCE', 63.72531105993943, [6249660.512011625, 63635.32800722724, 597.1208922489179, 92.16757402849588, 68.203063763539, 66.81945285436382, 66.00065323499967, 64.93433840901488, 63.72531105993943], (8,)),
    ('pose2d', 'inner'): ('NO_CONVERGENCE', 5313.020600553212, [1905166.142383419, 214569.36483033598, 74060.91893770105, 8040.992579148058, 6032.707981756651, 5430.301718267772, 5351.848850142964, 5321.080302643298, 5313.020600553212], (7,)),
}
# (d): Rosenbrock from (-1.2, 1), 300 iterations, (direction, search, NCG
# beta, loop) -> (termination, final cost, the first ROSEN_ROWS rows'
# costs, the answer); the quaternion fit, 200 iterations -> (termination,
# final cost, every row's cost, the answer). Nonlinear CG and steepest
# descent part from the JAX runs by rounding after their first rows
# (Rosenbrock's valley amplifies one-ulp differences): those rows are held
# to the JAX ones, the rest of the 300 iterations to the JAX termination
# (nonlinear CG + WOLFE) or to a fifth of the start's cost (the others),
# as tests/test_torch_line_search.py holds them on the CPU
ROSEN_ROWS = 6
ROSEN16_GOLDEN = {
    ('LBFGS', 'WOLFE', 'FLETCHER_REEVES', 'NEVER'): ('CONVERGENCE', 1.3964810174638379e-25, [24.199999999999992, 4.280493213725828, 4.128693836242695, 4.120150212898463, 4.115862962201533, 4.079298541918468], [1.000000000000262, 1.0000000000005507]),
    ('BFGS', 'WOLFE', 'FLETCHER_REEVES', 'NEVER'): ('CONVERGENCE', 2.565652682834634e-21, [24.199999999999992, 4.280493213725828, 4.128693836242695, 4.120687989540179, 4.117297985667059, 4.087019763978363], [0.9999999999640444, 0.9999999999245212]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'FLETCHER_REEVES', 'NEVER'): ('CONVERGENCE', 2.970637449858267e-12, [24.199999999999992, 4.280493213725828, 4.12241022876914, 3.156212689696727, 2.8661683405902596, 2.7476159090942676], [1.0000017230975289, 1.000003450163321]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'FLETCHER_REEVES', 'NEVER'): ('NO_CONVERGENCE', 0.009596722382770581, [24.199999999999992, 4.280493213725828, 4.12241022817601, 3.790458194654802, 3.7610833503459404, 3.7259568684511937], [0.9383620718501667, 0.8729092540396609]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'POLAK_RIBIERE', 'NEVER'): ('NO_CONVERGENCE', 0.14378268966162774, [24.199999999999992, 4.280493213725828, 4.122851688895107, 3.3807033224687735, 3.106984766699731, 2.7047085065425422], [0.6338602408387857, 0.3919175846960705]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'POLAK_RIBIERE', 'NEVER'): ('NO_CONVERGENCE', 0.03760251445207041, [24.199999999999992, 4.280493213725828, 4.122851687900448, 3.791907844362598, 3.7739843855767963, 3.742688379063679], [0.8062767532016325, 0.6492230281379986]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'HESTENES_STIEFEL', 'NEVER'): ('CONVERGENCE', 1.1525660877408917e-13, [24.199999999999992, 4.280493213725828, 3.5426578398219797, 3.428269690379302, 3.1442111335201948, 2.8807646322022107], [0.9999996608497626, 0.9999993201708327]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'HESTENES_STIEFEL', 'NEVER'): ('NO_CONVERGENCE', 0.019703319364708597, [24.199999999999992, 4.280493213725828, 3.5426329641281256, 3.424951465625532, 3.14034549046305, 2.877587442013013], [0.8600105572558853, 0.7385872595426854]),
    ('STEEPEST_DESCENT', 'WOLFE', 'FLETCHER_REEVES', 'NEVER'): ('NO_CONVERGENCE', 0.022221076679635358, [24.199999999999992, 4.280493213725828, 4.122851688895107, 3.9133507098374185, 3.807516525946217, 3.782928547051545], [0.8513786743112354, 0.7259979414360386]),
    ('STEEPEST_DESCENT', 'ARMIJO', 'FLETCHER_REEVES', 'NEVER'): ('NO_CONVERGENCE', 0.06907129172012087, [24.199999999999992, 4.280493213725828, 4.122851687900448, 3.911181014831911, 3.809586839992916, 3.78282976562386], [0.7377226294596377, 0.5425557717581295]),
    ('quaternion', 'NEVER'): ('CONVERGENCE', 4.225674491090508e-22, [2.0, 0.18140514634863655, 0.025073930080192198, 9.672073096302525e-06, 1.6396420895903126e-10, 4.225674491090508e-22], [0.70710678117928, 0.0, -0.7071067811938153, 0.0]),
    ('LBFGS', 'WOLFE', 'FLETCHER_REEVES', 'ALWAYS'): ('CONVERGENCE', 1.3964810174638379e-25, [24.199999999999992, 4.280493213706965, 4.128693836242194, 4.120150212898577, 4.115862962201498, 4.079298541918221], [1.000000000000262, 1.0000000000005507]),
    ('BFGS', 'WOLFE', 'FLETCHER_REEVES', 'ALWAYS'): ('CONVERGENCE', 2.565247384134193e-21, [24.199999999999992, 4.280493213706965, 4.128693836242194, 4.120687989540292, 4.117297985667069, 4.0870197639781845], [0.9999999999640468, 0.9999999999245262]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'FLETCHER_REEVES', 'ALWAYS'): ('CONVERGENCE', 2.911478343881093e-12, [24.199999999999992, 4.280493213706965, 4.122410228769329, 3.1562126907303973, 2.866168341771975, 2.7476159101603694], [1.0000017003687869, 1.000003414961693]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'FLETCHER_REEVES', 'ALWAYS'): ('NO_CONVERGENCE', 0.030692575717242324, [24.199999999999992, 4.280493213706965, 4.122410228176198, 3.7904581933148074, 3.7610833464715596, 3.725956870235944], [0.8297644097569279, 0.6843708365862857]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'POLAK_RIBIERE', 'ALWAYS'): ('NO_CONVERGENCE', 0.14378270580447589, [24.199999999999992, 4.280493213706965, 4.122851688895255, 3.380703322460164, 3.1069847666928716, 2.704708506537052], [0.6338602612492468, 0.39191759480757565]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'POLAK_RIBIERE', 'ALWAYS'): ('NO_CONVERGENCE', 0.04317448668904104, [24.199999999999992, 4.280493213706965, 4.122851687900596, 3.7919078444445273, 3.7739843856902566, 3.7426883791950005], [0.7924307088663248, 0.6270005104546472]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'WOLFE', 'HESTENES_STIEFEL', 'ALWAYS'): ('CONVERGENCE', 7.794098261376711e-12, [24.199999999999992, 4.280493213706965, 3.5426578398394306, 3.428269690381304, 3.1442111335218095, 2.880764632209634], [0.9999972109053192, 0.9999944095509308]),
    ('NONLINEAR_CONJUGATE_GRADIENT', 'ARMIJO', 'HESTENES_STIEFEL', 'ALWAYS'): ('NO_CONVERGENCE', 0.006443410808090979, [24.199999999999992, 4.280493213706965, 3.5426329641455943, 3.424951465742257, 3.1403454905983463, 2.8775874421295518], [0.9197295843826883, 0.8458758279249233]),
    ('STEEPEST_DESCENT', 'WOLFE', 'FLETCHER_REEVES', 'ALWAYS'): ('NO_CONVERGENCE', 0.00479427737802711, [24.199999999999992, 4.280493213706965, 4.122851688895255, 3.913350709616038, 3.807516526212307, 3.782928547081623], [0.9308464050700183, 0.8661277880386825]),
    ('STEEPEST_DESCENT', 'ARMIJO', 'FLETCHER_REEVES', 'ALWAYS'): ('NO_CONVERGENCE', 0.06940500850277133, [24.199999999999992, 4.280493213706965, 4.122851687900596, 3.911181010026438, 3.809586844807004, 3.7828297654392857], [0.7366296002055485, 0.5419825352828785]),
    ('quaternion', 'ALWAYS'): ('CONVERGENCE', 4.225674491090508e-22, [2.0, 0.18140514634863655, 0.025073930080192198, 9.672073096302525e-06, 1.6396420895903126e-10, 4.225674491090508e-22], [0.70710678117928, 0.0, -0.7071067811938153, 0.0]),
}
# the card against the CPU: C120 under LBFGS (LINE_SEARCH), and BAL-16
# DENSE_SCHUR with inner iterations, these many iterations (10 and 2 until
# the mesh phase came)
LS_CARD_VS_CPU_ITERATIONS = 5
INNER_CARD_VS_CPU_ITERATIONS = 1
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
# the 2,048-camera ITERATIVE_SCHUR card against the CPU (5 until the
# line-search phase came, 3 until the mesh phase)
SMALL_VENICE_LM_ITERATIONS = 2

# the mesh phase (port slice 19): every multi-device tier on BAL-16 at
# world sizes 1 (NCCL) and 2 and 4 (gloo, the ranks sharing the card), the
# CG budget pinned where the step's CG stops adaptively, as
# tests/test_sharding.py:441-447 pins it; scripts/sharded16_golden.py
# runs the same cases of the JAX package on the CPU's 8-device mesh. The
# two dense-Schur tiers run 4 LM iterations: after 2, a one-ulp change of
# the cameras moves the cost by 1.2e-10 (the phase logs it), above the
# gate, so world sizes could not be told apart from rounding there
MESH_PIN = dict(eta=1e-30, max_linear_solver_iterations=8)
MESH16_CASES = [
    dict(name="evaluator", tier="evaluator"),
    dict(name="solve_sharded", tier="solve_sharded", max_num_iterations=4, **MESH_PIN),
    dict(name="solve_sharded_fused", tier="solve_sharded_fused", max_num_iterations=4,
         **MESH_PIN),
    dict(name="solve_ba_cg", tier="solve_ba", num_iterations=2, step="cg", cg_iters=8),
    dict(name="solve_ba_schur", tier="solve_ba", num_iterations=4, step="schur"),
    dict(name="point", tier="point", num_iterations=4, k=4),
    dict(name="camera", tier="camera", num_iterations=2, k=1, cg_iters=8),
    dict(name="halo", tier="halo", num_iterations=2, k=1, cg_iters=8),
    dict(name="halo_ceres", tier="halo_ceres", k=4, max_num_iterations=4, options=MESH_PIN),
    dict(name="program_halo", tier="program_halo", k=2, max_num_iterations=3,
         options=MESH_PIN),
    dict(name="program_halo_quat", tier="program_halo", quat=True, k=2, max_num_iterations=3,
         options=MESH_PIN),
]
# the largest group first: its ranks start before the others' cases load the host
MESH_WORLD = {4: "gloo", 2: "gloo", 1: "nccl"}
# --cards N (port slice 20): the NCCL group of N ranks, one per card, at
# world size N and over subgroups at the smaller sizes
MESH_NCCL_SIZES = {4: (4, 2, 1), 2: (2, 1)}
MESH_COST_REL = 1e-10
MESH_STATE_REL = 1e-8
# the halo tier at the 2,048-camera instance, world size 4: its LM
# iterations (CG budget 10), against the same steps on one device
MESH_C2048_ITERATIONS = 2
MESH_DEADLINE_S = 300
# the kernels each tier must launch on every rank
MESH_ROWS = {"point": ("segment_block_sum", "segment_block_expand", "segment_spread_ftf"),
             "solve_sharded_fused": ("segment_block_sum", "segment_block_expand",
                                     "unsorted_segment_sum")}
MESH16_GOLDEN = {
    "evaluator": {
        "cost": 19012078.580987826,
        "g_sq": 5.133747025022723e+18,
        "g_first": [1875223.583560792, 496022.1384760955, 718783.2440297533,
            1714359.7184897913, 2879861.635556071, -254509.52608500427, 4058.1110666316463,
            588096.7139155021, 349252.9900666651, -730372.3512992808, 2316122.7677341304,
            1281122.88354554, -2494188.0370636135, 1982513.3019864417, -242977.2595719219,
            4940.290647783995, 314822.14384449605, -735691.6333234163],
    },
    "solve_sharded": {
        "cost": 55065.625536399995,
        "rows": 5,
        "cams_sq": [0.1861590803157892, 0.08024200254290238, 0.10449577376141103,
            2.014078330083395, 2.00979402711339, 1545.0345175085265, 4009343.926040612,
            0.00038479444052099386, 2.6073327959219287e-05],
        "cams_first": [0.0089056725606041, -0.01560960679822119, 0.06484248191412376,
            0.5167408028542526, 0.018952564600370814, 9.555693069911921, 487.4738437106342,
            -0.001140635354417778, -0.00038566190560549547, 0.006164991209950631,
            -0.055469455280823914, 0.0369384649859554, 0.4808469317673337,
            0.21109069936230676, 10.26528914195705, 504.1042961106103,
            -0.0008918033250354947, -0.0004895495657555062],
        "pts_sq": [90581.18375893311, 89245.2111587998, 7190512.263998144],
        "pts_sample": [-1.1860722608558756, 0.20075939962483152, -0.16128158479277857,
            0.9789483006612703, -1.6768997361631788, 0.6665660903891225, 2.198599915790008,
            -1.46788824927184, -0.4738326476719059, -5.872480559042958, -1.7205783193900221,
            3.861358215823871, -1.6437431133720506, 0.6241500296906106, 1.2466547999638742,
            -0.13859922964732016, 1.5323523649845543, -2.165320044139118, 2.3019311567390894,
            2.8067500333190916, 1.2562466379067598, 0.991571443192211, 0.43045131527342895,
            -0.3932182335468205],
    },
    "solve_sharded_fused": {
        "cost": 52886.539618677096,
        "rows": 5,
        "cams_sq": [0.18677256876668952, 0.0805741430191505, 0.10443118587730965,
            2.030240590975617, 2.007404218634436, 1541.857649585959, 4022194.51468329,
            0.00033466184302771387, 3.954767955909339e-05],
        "cams_first": [0.011234908206318757, -0.015912175007635893, 0.06482922268273746,
            0.5226529572829058, 0.018137169832823208, 9.51723495955395, 487.01412727269303,
            -0.004050696854486658, 0.0010496246047882792, 0.008727549159806811,
            -0.05591489299280353, 0.03703293973194683, 0.490660514085126,
            0.21169079560908388, 10.258162941968335, 504.84428887649915,
            -0.004090033595388302, 0.0009519762773685101],
        "pts_sq": [91921.98952138615, 90603.18202325863, 6151785.769075619],
        "pts_sample": [-1.195617202329821, 0.20418039302428626, -0.056430576207082056,
            0.9858772252022645, -1.684638293111188, 0.7724432710271261, 2.308111736659146,
            -1.5355442667390764, -0.08460227748741242, -5.951091382010848,
            -1.728760301142193, 4.075835247153739, -1.655680503383803, 0.633753700410545,
            1.3576754197835053, -0.13909267296010228, 1.5416715693496574, -2.071625477448111,
            2.3131577238757326, 2.8257976175568946, 1.3318609807019388, 0.9995958204028649,
            0.435620203334112, -0.28896802650698755],
    },
    "solve_ba_cg": {
        "cost": 88562.47634825992,
        "cams_sq": [0.18387330789235298, 0.07919911186672096, 0.10456344241802026,
            2.0170737428642656, 2.007728279022056, 1545.355038431247, 4007808.4755273466,
            0.000662155603031746, 0.00015414346547018082],
        "cams_first": [0.008332258635046039, -0.014810279111219984, 0.06477714122454122,
            0.5177229649451499, 0.020006649802488757, 9.591315701246552, 489.26379202064123,
            0.0026241188446639724, 0.0011856738056605118, 0.00582441895398251,
            -0.05449296923687964, 0.03694504645435373, 0.48120687009063656,
            0.2119749162703676, 10.264926854755581, 504.28910062975916,
            -0.0017268224449786497, 0.0003902777607705285],
        "pts_sq": [90453.25222055864, 89075.66655516939, 122755.58641735344],
        "pts_sample": [-1.1868137864285007, 0.20048216285286713, -0.15647522559088883,
            0.9811449102047699, -1.6823573021811002, 0.6945134226205898, 2.160328978118018,
            -1.4429307282723973, -0.5877374133803516, -5.856713438589191,
            -1.7218254024936428, 3.8236898527329957, -1.6445456304461903, 0.6250404849934819,
            1.2425983369484224, -0.1356165252456656, 1.5300812266217438, -2.1793268037917612,
            2.3340734993484484, 2.8512835179922518, 1.423612530665417, 0.9901100816044419,
            0.4287574373956498, -0.40430646882649257],
    },
    "solve_ba_schur": {
        "cost": 53609.10841754373,
        "cams_sq": [0.18867749834273792, 0.08238881775999436, 0.10425112232084371,
            1.9773188993210085, 1.9646493776940699, 1529.1179074594643, 4062774.243399286,
            4.2450593995017386e-05, 1.1304923907781553e-05],
        "cams_first": [0.01022525972631811, -0.021372287380694358, 0.06479330656113784,
            0.5140861450764391, 0.018671083834935518, 9.47693940385344, 489.29870782211134,
            -0.0014195620201812866, 0.0006316343156503699, 0.007840824244389102,
            -0.061561219191371745, 0.03697847884437793, 0.48011642175374647,
            0.20934114279283209, 10.218173378453203, 507.6379899209242,
            -0.0010005176803546997, 0.000312303735062034],
        "pts_sq": [89142.60391644877, 87939.89420033261, 8930679.061178861],
        "pts_sample": [-1.1784612664021812, 0.19967686732325374, -0.11059230437924708,
            0.9727145659175942, -1.6597659595564893, 0.6876460055439304, 2.270885742339067,
            -1.5130464701621973, -0.15827787926431205, -5.813020785612696,
            -1.7002062484571832, 3.9392361508500886, -1.6223313272038813, 0.620051128735446,
            1.2749476807209463, -0.14776102020908785, 1.5225383263159054, -2.091028035193439,
            2.278916205627823, 2.774508269603369, 1.2322231197380242, 0.9823800349949177,
            0.42798563890768, -0.34857910746788867],
    },
    "point": {
        "cost": 53609.108417551535,
        "cams_sq": [0.1886774983427341, 0.08238881775997728, 0.10425112232084642,
            1.9773188993211965, 1.9646493776933696, 1529.1179074594802, 4062774.2433992643,
            4.245059399518854e-05, 1.1304923907817111e-05],
        "cams_first": [0.010225259726537832, -0.02137228738063273, 0.06479330656114106,
            0.5140861450768293, 0.018671083834162782, 9.476939403853535, 489.29870782211015,
            -0.0014195620201841418, 0.0006316343156511583, 0.007840824244609437,
            -0.06156121919131306, 0.03697847884438555, 0.4801164217540699,
            0.20934114279202692, 10.218173378453223, 507.6379899209226,
            -0.0010005176803579863, 0.00031230373506313237],
        "pts_sq": [89142.60391643082, 87939.89420031747, 8930679.062243244],
        "pts_sample": [-1.1784612664024643, 0.19967686732399362, -0.11059230438054918,
            0.9727145659170205, -1.6597659595553613, 0.6876460055430672, 2.2708857423383892,
            -1.5130464701612736, -0.15827787926504377, -5.813020785612686,
            -1.7002062484553309, 3.939236150848517, -1.6223313272041893, 0.6200511287364453,
            1.2749476807193727, -0.1477610202093812, 1.522538326316052, -2.0910280351947566,
            2.278916205627074, 2.7745082696041115, 1.2322231197361877, 0.9823800349943993,
            0.42798563890833946, -0.3485791074690991],
    },
    "camera": {
        "cost": 88562.47634826282,
        "cams_sq": [0.18387330789235304, 0.07919911186672104, 0.10456344241802026,
            2.0170737428642664, 2.007728279022056, 1545.3550384312468, 4007808.475527345,
            0.0006621556030318375, 0.00015414346547019752],
        "cams_first": [0.008332258635045551, -0.014810279111219985, 0.06477714122454119,
            0.5177229649451501, 0.02000664980248936, 9.59131570124655, 489.26379202064106,
            0.002624118844663821, 0.0011856738056600087, 0.00582441895398206,
            -0.054492969236879664, 0.03694504645435369, 0.481206870090637,
            0.2119749162703683, 10.264926854755577, 504.28910062975905,
            -0.0017268224449788145, 0.00039027776077042915],
        "pts_sq": [90453.25222055858, 89075.66655516933, 122755.58641735374],
        "pts_sample": [-1.1868137864285009, 0.20048216285286638, -0.1564752255908898,
            0.98114491020477, -1.6823573021811011, 0.6945134226205885, 2.1603289781180166,
            -1.442930728272397, -0.5877374133803549, -5.85671343858919, -1.7218254024936457,
            3.8236898527329926, -1.6445456304461903, 0.6250404849934809, 1.2425983369484186,
            -0.13561652524566495, 1.5300812266217443, -2.1793268037917577,
            2.3340734993484475, 2.8512835179922518, 1.4236125306654193, 0.9901100816044416,
            0.42875743739564975, -0.4043064688264917],
    },
    "halo": {
        "cost": 88562.47634826294,
        "cams_sq": [0.18387330789235307, 0.07919911186672103, 0.10456344241802026,
            2.0170737428642664, 2.007728279022056, 1545.3550384312468, 4007808.475527345,
            0.0006621556030318406, 0.00015414346547019633],
        "cams_first": [0.008332258635045553, -0.014810279111219963, 0.0647771412245412,
            0.5177229649451501, 0.02000664980248942, 9.59131570124655, 489.26379202064106,
            0.0026241188446638882, 0.0011856738056599517, 0.005824418953982049,
            -0.05449296923687964, 0.03694504645435369, 0.481206870090637,
            0.21197491627036835, 10.264926854755577, 504.28910062975905,
            -0.001726822444978757, 0.0003902777607704123],
        "pts_sq": [90453.25222055858, 89075.66655516933, 122755.58641735394],
        "pts_sample": [-1.1868137864285007, 0.20048216285286627, -0.1564752255908904,
            0.9811449102047696, -1.682357302181101, 0.6945134226205861, 2.1603289781180166,
            -1.442930728272397, -0.5877374133803548, -5.85671343858919, -1.721825402493646,
            3.8236898527329917, -1.64454563044619, 0.6250404849934806, 1.2425983369484177,
            -0.1356165252456648, 1.530081226621744, -2.1793268037917577, 2.3340734993484475,
            2.8512835179922518, 1.4236125306654195, 0.9901100816044418, 0.42875743739564975,
            -0.40430646882649085],
    },
    "halo_ceres": {
        "cost": 55065.62553639945,
        "cams_sq": [0.18615908031579034, 0.0802420025429027, 0.10449577376141098,
            2.014078330083391, 2.009794027113391, 1545.0345175085256, 4009343.9260406117,
            0.0003847944405210333, 2.607332795920551e-05],
        "cams_first": [0.008905672560604296, -0.01560960679822184, 0.06484248191412376,
            0.5167408028542522, 0.018952564600370626, 9.555693069911909, 487.4738437106337,
            -0.0011406353544195732, -0.0003856619056062539, 0.006164991209950558,
            -0.055469455280824496, 0.036938464985955294, 0.480846931767334,
            0.21109069936230676, 10.265289141957044, 504.1042961106102,
            -0.000891803325034976, -0.000489549565755624],
        "pts_sq": [90581.18375893295, 89245.21115879972, 7190512.263995402],
        "pts_sample": [-1.186072260855875, 0.2007593996248315, -0.16128158479278576,
            0.97894830066127, -1.6768997361631783, 0.6665660903891212, 2.198599915790022,
            -1.4678882492718504, -0.4738326476718745, -5.872480559042963,
            -1.7205783193900204, 3.8613582158238793, -1.6437431133720513, 0.6241500296906087,
            1.2466547999638766, -0.1385992296473214, 1.5323523649845554, -2.165320044139113,
            2.301931156739083, 2.80675003331908, 1.2562466379067228, 0.9915714431922119,
            0.4304513152734299, -0.3932182335468156],
    },
    "program_halo": {
        "cost": 55065.62553639945,
        "cams_sq": [0.18615908031579034, 0.0802420025429027, 0.10449577376141098,
            2.014078330083391, 2.009794027113391, 1545.0345175085256, 4009343.9260406117,
            0.0003847944405210333, 2.607332795920551e-05],
        "cams_first": [0.008905672560604296, -0.01560960679822184, 0.06484248191412376,
            0.5167408028542522, 0.018952564600370626, 9.555693069911909, 487.4738437106337,
            -0.0011406353544195732, -0.0003856619056062539, 0.006164991209950558,
            -0.055469455280824496, 0.036938464985955294, 0.480846931767334,
            0.21109069936230676, 10.265289141957044, 504.1042961106102,
            -0.000891803325034976, -0.000489549565755624],
        "pts_sq": [90581.18375893295, 89245.21115879972, 7190512.263995402],
        "pts_sample": [-1.186072260855875, 0.2007593996248315, -0.16128158479278576,
            0.97894830066127, -1.6768997361631783, 0.6665660903891212, 2.198599915790022,
            -1.4678882492718504, -0.4738326476718745, -5.872480559042963,
            -1.7205783193900204, 3.8613582158238793, -1.6437431133720513, 0.6241500296906087,
            1.2466547999638766, -0.1385992296473214, 1.5323523649845554, -2.165320044139113,
            2.301931156739083, 2.80675003331908, 1.2562466379067228, 0.9915714431922119,
            0.4304513152734299, -0.3932182335468156],
    },
    "program_halo_quat": {
        "cost": 55074.76390512653,
        "cams_sq": [15.907596383965533, 0.04638890925034711, 0.019997356553592333,
            0.02601735023052937, 2.014092826822154, 2.0098184074330336, 1545.0579015304713,
            4009380.4244659725, 0.00038472757557519126, 2.61800378143321e-05],
        "cams_first": [0.9994340239671498, 0.004438274707279444, -0.007795568471960858,
            0.032421637322193234, 0.5167496455058016, 0.018955775446548973, 9.55581382006084,
            487.47825970942944, -0.0011328750056470744, -0.0003799541203393919,
            0.9994402790866078, 0.0030677178843085315, -0.0277214360790519,
            0.018472672464506183, 0.48085702454188395, 0.2110939633138799, 10.26537327994188,
            504.10614968465364, -0.000893286846429146, -0.0004894171483457801],
        "pts_sq": [90581.5461207807, 89245.75217323765, 7204588.5817093635],
        "pts_sample": [-1.1860785363318485, 0.20076732520580592, -0.16131544143582033,
            0.9789223557376416, -1.6769423131753063, 0.6665559702708833, 2.198500627112327,
            -1.4678644603727136, -0.4741345728003256, -5.872384715067037,
            -1.7206899717418564, 3.860828311463977, -1.6437800342241087, 0.6241247283631411,
            1.2466679102604357, -0.13858406338339446, 1.5324429938766637, -2.16530207572394,
            2.3019502210829548, 2.80669948821422, 1.256482038996804, 0.9915661388734313,
            0.4304670243258809, -0.393127110245953],
    },
}

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
# (rows 6 and 7 also at BAL-16 SPARSE_SCHUR's first step: the chunk sums
# of the largest group of S's block pairs, 81 wide, the gather of the
# pairs' W rows, 27 wide, and the gather of the summed blocks to their CSR
# positions, 1 wide; row 6 at BAL-16 SPARSE_NORMAL_CHOLESKY's camera-camera
# blocks of J'J, 81)
ROW_CASES = {"4": [("normal_matvec_cgnr", "_cgnr", ["bal16"])],
             "6": [("segment_block_sum_one_key", "_one_key"),
                   ("segment_block_sum_w3", "_w3"),
                   ("segment_block_sum_one_key_w8", "_one_key_w8"),
                   ("segment_block_sum_sentinel", "_sentinel", ["bal16_gauge"]),
                   ("segment_block_sum_schur", "_schur", ["bal16_sparse"]),
                   ("segment_block_sum_jtj", "_jtj", ["bal16_sparse"])],
             "7": [(f"segment_block_expand_t{t}", f"_t{t}") for t in (3, 8, 9)]
             + [("segment_block_expand_sentinel", "_sentinel", ["bal16_gauge"]),
                ("segment_block_expand_schur", "_schur", ["bal16_sparse"]),
                ("segment_block_expand_csr", "_csr", ["bal16_sparse"])],
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
# the example scripts (port slice 17, examples_phase): each run of
# ceres_tpu_torch/examples/ as "script arguments", bundle_adjuster.py at
# BAL-16's shape (71,256 observations at its visibility of 0.2) under
# SPARSE_SCHUR (its default), DENSE_SCHUR, ITERATIVE_SCHUR and DENSE_SCHUR
# + HuberLoss, libmv_bundle_adjuster.py on libmv16 written to a file
# (LIBMV16_FILE stands for its path), the others at the tests' arguments
BA16_ARGS = "--num_cameras 16 --num_points 22106"
LIBMV16_FILE = "LIBMV16_FILE"
EXAMPLE_RUNS = (
    "helloworld", "helloworld --diff analytic", "helloworld --diff numeric", "powell",
    "curve_fitting", "curve_fitting --robust", "circle_fit",
    "circle_fit --robust_threshold 1.0", "robot_pose_mle", "rosenbrock",
    "rosenbrock --diff analytic", "rosenbrock --diff numeric", "callbacks_example",
    "evaluation_callback_example", "libmv_homography", "ellipse_approximation",
    "sampled_function", "bicubic_interpolation", "more_garbow_hillstrom --problem 1",
    "more_garbow_hillstrom --problem 4 --trials 0,1", "pose_graph_2d", "pose_graph_3d",
    "simple_bundle_adjuster", f"libmv_bundle_adjuster {LIBMV16_FILE}",
    f"bundle_adjuster {BA16_ARGS}",
    f"bundle_adjuster {BA16_ARGS} --linear_solver DENSE_SCHUR",
    f"bundle_adjuster {BA16_ARGS} --linear_solver ITERATIVE_SCHUR",
    f"bundle_adjuster {BA16_ARGS} --linear_solver DENSE_SCHUR --robustify",
)
# the kernels each bundle adjustment run must launch, under its path's name
EXAMPLE_PATHS = {
    f"bundle_adjuster {BA16_ARGS}": (
        "examples_ba16_sparse_schur", ("segment_block_sum", "segment_block_expand")),
    f"bundle_adjuster {BA16_ARGS} --linear_solver DENSE_SCHUR": (
        "examples_ba16_dense_schur", DENSE_PATH),
    f"bundle_adjuster {BA16_ARGS} --linear_solver ITERATIVE_SCHUR": (
        "examples_ba16_iterative_schur", ("eval_fused", "post_eval_fused",
                                          "schur_jacobi_blocks", "normal_matvec",
                                          "isc_matvec")),
    f"bundle_adjuster {BA16_ARGS} --linear_solver DENSE_SCHUR --robustify": (
        "examples_ba16_dense_schur_huber",
        ("eval_fused_loss",) + DENSE_PATH[1:]),
    f"libmv_bundle_adjuster {LIBMV16_FILE}": (
        "examples_libmv16", ("segment_block_sum", "segment_block_expand",
                             "unsorted_segment_sum")),
}
# scripts/examples_golden.py: per run, one (termination, final cost, summary
# rows, initial cost) per solve of the JAX script on the CPU
EXAMPLES_GOLDEN = {
    'helloworld':
        [('CONVERGENCE', 5.012552151786674e-16, 4, 45.125)],
    'helloworld --diff analytic':
        [('CONVERGENCE', 5.012552151786674e-16, 4, 45.125)],
    'helloworld --diff numeric':
        [('CONVERGENCE', 5.012669139575181e-16, 4, 45.125)],
    'powell':
        [('CONVERGENCE', 1.1200286988691504e-15, 15, 107.50000000000001)],
    'curve_fitting':
        [('CONVERGENCE', 1.0936116841978245, 15, 129.07845432025718)],
    'curve_fitting --robust':
        [('CONVERGENCE', 5.775120749038229, 15, 20.649300874664092)],
    'circle_fit':
        [('CONVERGENCE', 68278.91167507549, 17, 307739.29099973425)],
    'circle_fit --robust_threshold 1.0':
        [('CONVERGENCE', 61.658899930830785, 26, 484.9489352491954)],
    'robot_pose_mle':
        [('CONVERGENCE', 2.902060294291427, 4, 2825.8888459721347)],
    'rosenbrock':
        [('CONVERGENCE', 1.3964810174638379e-25, 46, 24.199999999999992)],
    'rosenbrock --diff analytic':
        [('CONVERGENCE', 1.3964810174638379e-25, 46, 24.199999999999992)],
    'rosenbrock --diff numeric':
        [('CONVERGENCE', 3.989103929851951e-20, 46, 24.199999999999992)],
    'callbacks_example':
        [('CONVERGENCE', 1.0936116841978245, 15, 129.07845432025718)],
    'evaluation_callback_example':
        [('CONVERGENCE', 1.3029493255353997, 15, 123.15010826142512), ('CONVERGENCE', 1.3029493255353997, 15, 123.15010826142512)],
    'libmv_homography':
        [('USER_SUCCESS', 3.237330648928859, 4, 30329.156937811666)],
    'ellipse_approximation':
        [('CONVERGENCE', 0.00976802775477527, 27, 428.2189989252299), ('CONVERGENCE', 0.009768027754775269, 27, 428.2189989252299)],
    'sampled_function':
        [('CONVERGENCE', 1.041892696315879e-15, 15, 75.03125)],
    'bicubic_interpolation':
        [('CONVERGENCE', 1.1181922721803592e-22, 5, 249.19349011720215)],
    'more_garbow_hillstrom --problem 1':
        [('CONVERGENCE', 0.0, 39, 12.099999999999994)],
    'more_garbow_hillstrom --problem 4 --trials 0,1':
        [('CONVERGENCE', 5.383621143800467e-26, 23, 499999000001.5), ('CONVERGENCE', 1.8291932369418993e-24, 26, 499990004902.0)],
    'pose_graph_2d':
        [('CONVERGENCE', 1.8883560750444215, 8, 890.6858516991026)],
    'pose_graph_3d':
        [('CONVERGENCE', 0.6092367104451426, 7, 33.730747164310436)],
    'simple_bundle_adjuster':
        [('CONVERGENCE', 2369.1964639220805, 6, 804860.0365678342)],
    'libmv_bundle_adjuster LIBMV16_FILE':
        [('CONVERGENCE', 51910.426705318765, 22, 19022831.405149613)],
    'bundle_adjuster --num_cameras 16 --num_points 22106':
        [('CONVERGENCE', 39906.985626289534, 5, 71619.4320325047)],
    'bundle_adjuster --num_cameras 16 --num_points 22106 --linear_solver DENSE_SCHUR':
        [('CONVERGENCE', 39906.985626289534, 5, 71619.4320325047)],
    'bundle_adjuster --num_cameras 16 --num_points 22106 --linear_solver ITERATIVE_SCHUR':
        [('CONVERGENCE', 39907.03481618889, 9, 71619.4320325047)],
    'bundle_adjuster --num_cameras 16 --num_points 22106 --linear_solver DENSE_SCHUR --robustify':
        [('CONVERGENCE', 33844.55757257597, 44, 56542.2048463431)],
}
# the run whose full_report the phase prints
FULL_REPORT_RUN = f"bundle_adjuster {BA16_ARGS} --linear_solver DENSE_SCHUR"
# each final cost within EXAMPLES_REL of the JAX script's (or within
# EXAMPLES_ABS_OF_INITIAL x the initial cost where the JAX one lies below
# that), the same rows and termination
EXAMPLES_REL = 1e-9
EXAMPLES_ABS_OF_INITIAL = 1e-12
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
         "segment_block_sum_schur": "segment_block_sum",
         "segment_block_sum_jtj": "segment_block_sum",
         "segment_block_expand_schur": "segment_block_expand",
         "segment_block_expand_csr": "segment_block_expand",
         "segment_block_sum_cluster": "segment_block_sum",
         "segment_block_expand_cluster": "segment_block_expand",
         "segment_block_expand_csr_matvec": "segment_block_expand",
         "segment_block_sum_csr_matvec": "segment_block_sum",
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


def write_libmv_file(path, lp):
    """Writes a LibmvProblem in the libmv bundle adjuster's binary problem
    format, as models/libmv.read_libmv_file reads it: little-endian, float32
    values, each camera's rotation as a column-major matrix (Rodrigues'
    formula of its angle-axis), images and tracks numbered by position."""
    import struct

    aa = lp.cameras[:, :3]
    theta = np.linalg.norm(aa, axis=1)
    k = aa / np.where(theta > 0, theta, 1.0)[:, None]
    K = np.zeros((len(aa), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    c, s = np.cos(theta)[:, None, None], np.sin(theta)[:, None, None]
    R = np.eye(3) + s * K + (1.0 - c) * (K @ K)
    f32, i32 = np.dtype("<f4"), np.dtype("<i4")
    cams = np.zeros(len(aa), [("image", i32), ("R", f32, 9), ("t", f32, 3)])
    cams["image"] = np.arange(len(aa))
    cams["R"] = R.transpose(0, 2, 1).reshape(-1, 9)
    cams["t"] = lp.cameras[:, 3:6]
    pts = np.zeros(len(lp.points), [("track", i32), ("X", f32, 3)])
    pts["track"] = np.arange(len(lp.points))
    pts["X"] = lp.points
    marks = np.zeros(len(lp.markers), [("image", i32), ("track", i32), ("xy", f32, 2)])
    marks["image"], marks["track"], marks["xy"] = lp.marker_cam, lp.marker_pt, lp.markers
    with open(path, "wb") as fh:
        fh.write(b"v" + struct.pack("<B", ord("P" if lp.is_image_space else "N")))
        fh.write(np.asarray(lp.intrinsics, f32).tobytes())
        for table in (cams, pts, marks):
            fh.write(struct.pack("<i", len(table)) + table.tobytes())


# NIST-format problems of the five shapes of tests/test_nist.py's fast subset
# (port slice 18): the model, its parameters (the StRD certified values),
# the predictor's points, two starts (the StRD starting values) and the
# responses' relative noise (Lanczos3's data are the model's values to
# five digits: more noise leaves its six parameters unidentifiable)
# the covariance phase's 400-camera core (the JAX slow test's instance) and
# the camera blocks it asks for
COV400 = dict(num_cameras=400, num_points=2500, mean_track=6.0, cam_window=40, seed=0)
COV400_BLOCKS = 16  # 64 took 14.5 s of host column solves on the card, 13.4 on the CPU
# the covariance paths of phase (a), by Covariance.stats["path"], and the
# kernel rows each launches on the card (the pure QR none: its evaluation
# is the plain one, its factor the host's); denoising's flat CGNR (one
# pixel family, its rows sorted by it: row 6 sums, row 7 gathers, no row 9)
COV16_PATHS = {"qr": {}, "schur_tail": dict(schur_tail_min_cols=128),
               "normal_equations": dict(use_normal_equations=True)}
COV_PATH_ROWS = {"qr": (), "schur_tail": ("segment_block_sum", "segment_block_expand",
                                          "segment_spread_sum", "unsorted_segment_sum"),
                 "normal_equations": ("segment_block_sum", "segment_block_expand"),
                 "denoise": ("segment_block_sum", "segment_block_expand")}
COV16_REL = 1e-8
ROTATION_BATCH = 1 << 16
TINY_LANES = 1 << 20  # TinySolver.solve_batch's lanes on the card
TINY_GOLDEN_LANES = 4096  # the first lanes, held to the JAX solve_batch's
# the golden's units: a lane's x - truth, its final cost over its initial
TINY_X_QUANTUM = 5e-10
TINY_COST_QUANTUM = 1e-13
DENOISE_SIZE = 256  # examples/denoising.py's image, pixels a side
DENOISE_ITERATIONS = 20
NIST_SHAPES = {
    "Misra1a": ("misra1a", (238.94212918, 5.5015643181e-04), np.linspace(77.6, 790.2, 14),
                ((500.0, 1.0e-04), (250.0, 5.0e-04)), 2e-3),
    "DanWood": ("danwood", (0.76886226176, 3.8604055871), np.linspace(1.309, 2.274, 6),
                ((1.0, 5.0), (0.7, 4.0)), 2e-3),
    "Lanczos3": ("lanczos", (0.086816414977, 0.95498101505, 0.84400777463, 2.9515951832,
                             1.5825685901, 4.9863565084), 0.05 * np.arange(24),
                 ((1.2, 0.3, 5.6, 5.5, 6.5, 7.6), (0.5, 0.7, 3.6, 4.2, 4.0, 6.3)), 1e-5),
    "Rat42": ("rat42", (72.462237576, 2.6180768402, 0.067359200066),
              np.array([9.0, 14.0, 21.0, 28.0, 42.0, 57.0, 63.0, 70.0, 79.0]),
              ((100.0, 1.0, 0.1), (75.0, 2.5, 0.07)), 2e-3),
    "Eckerle4": ("eckerle4", (1.5543827178, 4.0888321754, 451.54121844),
                 np.linspace(400.0, 500.0, 35), ((1.0, 10.0, 500.0), (1.5, 5.0, 450.0)), 2e-3),
}


# The JAX package's answers on port slice 18's paths (satellite_phase):
# scripts/tiny_solver_golden.py (TinySolver: the first TINY_GOLDEN_LANES
# lanes' iterations, x - truth in TINY_X_QUANTUM units, final over initial
# cost in TINY_COST_QUANTUM units, packed; Rosenbrock's x, final cost and
# iterations) and scripts/nist_denoising_golden.py (each NIST start's final
# cost; the denoising rows' costs and CG iterations)
TINY_GOLDEN = {
    "iterations": (
        'eNqNl1kSwjAMQ2de7n9nGKY0XiQn5aO0BMeLJDtr7Yvv53dLj/sN71dY7SLd3rfBBm4V2QnebfpCwttqj7r5'
        'Gw91S6KHaBP8/zb9O1nqoYmHFBQqZ4PxpdOP8MoajZEitoHnZ+JuVH8fA0j/kb761Hh3DVLQd6ylHW+rqnYf'
        'B/QWR8EhPCAWFChUW/R6kZCZ005PAUgkoXKHc4i4A4rOICrWS4hkOHOd6XwlB01HFAfivKGA4Q+pYBPIpAi4'
        'IBjX/JCBgDF1mdlBxh0j2DXkQKaY8815PLuWgGZxSitzBnCGrHYK91gVCImhEwoL1vBq0wQGX39DkBtoKE+3'
        'UEGiYM8+ug9TwcTkgnGcCftwIeJ/dN20M2pMm79Y9bcunZpxTXTofJQ9D9mbBhsMjQW0jTLg+jt2SHjcp1Ej'
        'zlmxK8wMTFJxGFsUS/D9yFMU0ViaLarsqJmRyUu6uPV5l0gluEf/a6mOUASxF5UrI+Nxwkl0lZUUpHLZsSPC'
        'ylNU8M4ABjSvL69YU8ax2Uk+R9WjwktPyER0MJE2DDA47zgHLU4AEYBwGqUmlFzKtj4KNq6s5SSePKaw5Gmi'
        'N0ragTTRKK0TiYALneZ40qpia0coLHdw6qOmwzWf7BCyxXg4kWHuJH4A+ZotoA=='),
    "x_minus_truth": (
        'eNq1XQmQHsV1nvn3QBI6kWSBgYAwlwAbsDjCYcDCnHbhCgECNokdOy4biA0GLAIURcAGx4BxMJAY20DA4igI'
        'lzBnLAjIHLbAFCKAkNCiAwkJSauVtNr9r5nJPPbr2qe33T2v519NVdf/778z09frd3zv9eso8l9JlmXme6b4'
        'nrLvZa4T8rJHXi4S74nzskNeHmC/9VrqorY02O/N/HtH/rlNXm6Io5av2FLvm/nfO+Wf5yVb/t6P+w7Bc9S2'
        'umd8KnnpzMtqcQ89R8+3s7GmPt6dl//Ny4s0SflFz68Tc1HB9w34XY4Pnz96TRvaMdLyf9tYL83Lh3k5znGP'
        'dsgvzMsz+Tveigfm+dC83IF+S7pqlcaKaFheNF5U53rPONjWi+ueFDQ5Pi8LPPWmmI+Nyr43B8ggW4NPGrsq'
        'u7+uaFvWwj2y7WbuavhOzzXFe0bnn+Py8sv8+xfzz13zsh3ab54NaVvquYfGcVNe/oqtjXXi/S+gjYsFDzH9'
        '2Szun5x/7pKXPUHrsYUGzFw0lH2hPn82/36jZ5xj1jbX+G+NtcCv/wM/m59u+WxcQG+utnW02LaVoKeLUAcV'
        '4tWHgp8tyb93Yd6XpkPfE2M8uzH/c0RdhgbqyvZQPURrzzrok57dAJr8nYceYnavbC/R2gceuWxbdxoakPfv'
        'npeD8nIpW5sJkyndDl5N/yPZ+y7JKXZPg7WN1tRErK2bC2g+ZnLVdk3N//cy8erY388K3kPydtu8vKMYn8Qy'
        'tsSfl4tnt8vLfWJd2PpCda8S7+zE/yYwOpuXf9LfO+flNcWacvGf+jDJzaSELCA+S+P8vJJX87+7oV9d7aFz'
        'WkM0D3OV80jrcmxebhbysQPt2lyCH7ouo1P1Yx5iIddi0fez8/L5/PvBFfv8avVtuU598yjlTw/45+FYlyNA'
        'h0vw+3xFv7n+2Sn+t1de3ifepdAVM9RJF+kz20EXfgq/G12beD3pDz8oWHcZ+lckW1MPvRlZ0MSaJV3uN+xZ'
        'at+xedk+L9cp7KYIdg/R8WOsjimibaflhXjl0fFAXRXoh4auNop37oQ2Hh7b7SONnPXRv5nXzdCPqf17OeRm'
        'v+D/ZL/cn5en48E6XHW1KeyRVLzf3KfVe2tMXyhaX1KPNXTel39PQBNvWO6hzz7PeNIYkv3z97FOF0qg174r'
        '3tmL/rzOxrXpsPsaSv5G94/KP19S8m3X9Tl8LlD0sWiNtnrZ9LEOyzriVxV22fueNULtIx7z74wOm2wuEvCy'
        'qqA3/q56oE7SrrTZSQd+Utiz5j1cTzA0Ews8w1zfy8vpebnHwm/bPLYbX+uhOolcj8bm/dDxnn5Rr5yLEPso'
        'ZjZCyLO07sfg2cNYO6Qe1cb4kKu/RTzEt3ZGwMa6g8211AESyJ2Nivc3Au07WZexcw9GW+i5BwJlUIX9ryls'
        'EDNfDTHv7Xiuy6GDaWxq2Ueqg/jae0yX7PaMoblqXM6XxGGKZHob2vuxRS4bWuL28l/ychbZbKndHqR5XJYX'
        'oqPb2dzVSuj2ITw/Y3TbcNiqvvfz/pZtp5YvcQxEYnE0fiOjcNlHNtRU6L28nncxbzvHA+1oCv02ZfTWD/on'
        'PvBhoI0j+fZB0Hv/RvFsDfW3Qy4W3d+vsHfod8Ld3oPOXBH6sOGxO6LO0/MyHv2+lfGKpACL2xaYfMLoh3gH'
        '/fbDdPA9Tay10dDjY4EfJ8Ku1Og39MxdsPsXxQNyhLCAc0rIrxGYrysZP2ygzZHANn02PvWN2vELBf1UxTs5'
        'Hx4LXO7FtBijljK/B3Nzu7jf9GEnC7+1vX8qdPY7yW7Jv38qLx94bHPJTwjbOjwuln1pCUzY0G+/w77TYi82'
        'udOw8Cuzrmm9rMg/71XyyZjhG5o1a76vEe9cCTlItDUZfoFjAn2RoXpZzfPsH2GjTon9mAmny3bgzLwOTTuN'
        'fbheST/HYu3sLvwstrpihe3Q6eD1DaX9q6H/dvi77lHO3Ui0fb1j7fQG6p9xSX1D2kf9WPttaJvLV2XzB/no'
        'lvjz2vy3rw+TD46uSbDFkrQ8hin1XtJzd4TtFxX0MWphzM3fNM+nYswrkD+ausya6gW/I3mz0IKTUNt3t+jF'
        'ks7L6LQP5oUwwK6kuM11tpZf9ozVR/n/FkL/iJjO46J54qVH5eX8Ah4ufQTNraDDt+KjLHpX7OFXho7onsdE'
        'H5cDb5/l6ItNdnd6eGkqeC/5Scl3M0FJ/xVh19r4cA10a8Mh6X+vMuzmYxZvsJi9t6qQEbzeNmA+++ZlTqzz'
        'G2ov7hMpsiWNvdkdyHOqmd3nWwNPM7ETNr1Ryv1VGNPDPFiKzW5NoTuTDfJcXki/Ib/o22nYmkoL+p4W2JhZ'
        'gC3smq9tHfK1Ymlnxnw15toO+vZd6aC91q/kLRXU12eZ39TznsRC87FlPJdifn8dD9otm4HXToQN5sPEDD3s'
        'Fg3EtJyg1JcqjFe57qc4qa8RDu+hmYTpJN2we28Gr6M6rhfP/AX40K2iPTQG5EM4J6+L9HHC6xYz39dapa5l'
        'fOWbHD6ItCCOIgbebnjeI8MoO3hbPoJ/8UKF3yETOENZ/4XkGxfmf/9nXm6DvU9687/BNvp9/nlLgMy18aWX'
        'YT9/Px6sf43jPSMcukLVwifJFv4d7OhpZBcX6GYP5+WnBfqABm+PLf5B8qH9iWzZSrHu0fTQsPEvbHTE1Ml5'
        'Hwme9kQ8OMcGR9qM/0ted7jF1rDZX67xMdiS8deb71w+Uv3/lH8uysuzbX6cLoYdIvG4EZbfXddRwCW70gF+'
        'Q+/stugqJtaC+Azp56djfZNu+5RDtspx6ASfOt+xBs38tkPmuK6FiKU6E7b//vnnZRb/CM3JIuUa53ZED/yL'
        'zyjHMEVdKywyohN6nW1dVR2YgEuv6/K0ZzHwoJ0csSJ1z7yQvCA/wUslcCof3/DpA+sYzdSUPJnu3WCJwaM5'
        'I9/UFYExdakDE6Nrv2ggju6daMCPfhetg8rgu3sUPiNN/EYTsTBnEEaRthYLavr6cw+mRzjIjPz7b0XbdsWa'
        'meKJ66gwHmPjsXS9Chx+msBaTfzjCA/Gshr2feqIUXTJmlj8j/COI0gHUtBVG3uuXhDvEQFP8eGKKXT1OBrq'
        'I7bJZ9PH0fBHXIu1QXrtMcKmM34J0g2PAo//0TDF24dgAqkjxtWH9TUQW0gYx5tiXoz9u8Jh72SB+KELf0sU'
        'PDZT3EPXcugI3B6MLTZMF3xernYuhz7/28D9OxlbgwmzfY1fZSViRyTvpTEbx2ReTTm2lYL5rVv8mO3QJUzs'
        '9L6OOaqw8asq6JnHDyxCPbFFzrrm9CHM3dUFOL+UTSmTWT6Zwnmxdu3FSqw+VWJTpGdRrPRp6WCbpa1q+NSN'
        'Fn9ZG9ZjyPoy8T2nkvxU2PXSD7UPxdRSuytD+2JivnYEnkF85ED0aa/Evq9ByvQLgL/OTXU4f8WBR+0NHjZL'
        'PPs62rizx2Ycgzk83EIzBhfdHv6Af1Dathp9rI3JWNc9TbSdYldn5N/JNjxWEfuXWmSx8RvbZITPBqf19gTp'
        'opGuXsPHGllxLHF1GGPFbX3X4LRNB39IA+VdBsyKfJiXicqmYI2sFPrkQdBjfgN9rIF4fRufn+zQtST/oTiw'
        'r+afX00HaJ9k/HzH/Q1HbK18/yZgO2d7xr1isWuKfAH02WOxHVIPPkbXnsBJLgIvIpvuBvyvXennMvRBtvkr'
        'zEfWo6TDcZjTeY444dhSF2ErD2JPCj17lIgT+3T++QfykcRuH6LrewweNcPyeyXy+981Mno7+M/2d/gaDA3Q'
        'fCxQ1OXTJ9vAl6/x8BkjFzm9bSN4p0aPqjNd19XWEcCanmTz2nD41sluXwWe+aACx9TEgmrjQn26DMWfL3X4'
        '1ouuj0W8kG2vnGxPNcDW0/j1JoAHcqymC/J9W4VeWst0e/CnQJf4YzrUTvHJCN+el07U//Ew2YOu+IqmYk9T'
        'KnxqRbTkipttOnyL/YhvJL3wcuDjtB90e/Ee4hMkL8+DLmT04d3gU3me8fP5lraRLnMIw6ue8eAPpt3a2G/D'
        'N9eJ359BjG+keE8seL9mnE2s535C96cxJEz+cqaT9gbGdPE43k0Wu9UVh2Z4Bdl1fyasqoCGOzE3nCe8AZzh'
        'WYHrhrSft1WDRdjWqW/fhA0bbwKDNbQtbW3jJ95ZaYu56p0LP+Of02KfoHTLdEBWLrHUFaILuS6T22KDZY2Y'
        '/alFOrZrXiKseerDpXn5DPpzp6WdCTBeI2/6AjAZ37qT8/4lyPuxlr20VOd4D8//RG4I7CgCjlhHTJOrbdtA'
        'f/vbaCCOluZ0ZomYVamHx1G5uKN2zNW6wNwRTUucOc3rgnSoXmrzsxh9aFnBHjGJlZWJ8TNz0DuMdii1jfCW'
        '++Ni+1S2ZT1s/AOwbjdAx3G1bRRoay7LZfCABculMsmxriUmMB485pcKOqHfD4NvZiru6RC6tE8vMj6MPodP'
        'oQ6++IlNbcFGIo9fNVXyhxehry9z9C/x+M5848P9s7b4DZuN38d0oZ7A/elGdhMtE9b8FuTKpnQwhmSe6PvJ'
        '0MFGBa5xzd75pmNfT8OBbU4t8KOZ/nKsZiz6fRiT2ZMdctOmPxLuMpsJ1H4PHco2GD2sD/N8pkIHSJE/gfS5'
        'ywLlZhEu2gufqwa/csnEFfDdTwjEM43tbWz/SRizOaJjr4GnfUPJt/cEP3oddhmNM+UM+jTmalGg70nqhG34'
        'bQN4bwKci9OYIY95gf4gM7607n8vfr8G8TUfVrd+DiLb3tvMgV249rn7fEBk51EM8B15OTcv387Lv6YDsnkU'
        'MKMif2VRDFsD+13L+kxde4iqsOcIy5sOPZrG4Fwlnx+uXFKfx70/ZvRWFKvgwt86gWfa+FjKZO4KC+ZG/Xhc'
        'zAuta8ItL/e0fzfI4dkt7GXgdugK6L+n5J83tg3wlQrwK987ub3jwwB9fGwUxrArcP9CIvjMHPh2Gi3sH5FY'
        '+sz882mKUW+E+Sls2GkNe5E17RgB+niSjW0b8Bfi0VmBDhCX5Gkmr9BEJf0Ye+J5zzpdC578CNu7rd1bejR8'
        'gNfHQzGAiPlEn8DczwBmdJR4/wTQ6suI5dwPtl+R7W/+9u2/88VXvAMZd2DgXto62+u6Ntty326RfV0G56xD'
        '3pMfZBusxwUiBwhv42ToBpezNf+ggwY0dNiw2KTUhkWO8VnvkJuuGL+E0SHPp9eO8SX+fWVg7F/qiEWpKvCQ'
        'TLFvl/9fuy/P5ws2uG0c2fcRROxZE4f/OPufD/9cgfd2OfgP91msbgFD0NyTKPzgNeDmZMvLfLBHAl9cItaH'
        '9I9w+0XuGUnQ38nR0P2qGr4h8SVJ2/I93bDNvltiDHnuEbMmepX5RkLwYd86KsKoE0UMfKIYTy3/mY04+rNY'
        'W3w5i4yNuj4bnv2G8iIbjGL13y3w79swc9d1P/jod2JdHieSxbQ/8FsePcfow7M9+frIliTf7qjKIA6zpmBO'
        'Y4bZdkHeTwdue7IjH1QNe0+b8KNoeI4rbrmGOJGO/HMPYMZr0oE995SHd3Y6WG87cCXSL6YFYkqhe3MqHpv0'
        'Vcj0mR7esk80sD/wYEXuKVsOHxff43GDvrjECH4O6sdzCgwzVeg/xg4hG+kdYCQZyy9n7GtfnvMUMdwuXboD'
        'xWcz9oBepzH5RzrTgbC3rhI0YNtfVsa/I/EfwrZ/EA3mORvp4Xu2OZXrMXbYSiE2UZFNWrQ/OmP7HMvyfA12'
        'zf07/WJeYkZLmrlopZ1dsEWvjIeOBc3nPwb2S34fD3r+ZosxS9Q3klM3iXt+lReyhfarFMtEE1dF/OuFtDU/'
        'kcFTljt00dTB/2ue/Hvm2c3M/zJO1MnziBp+tFJ57oCJ1ZA43vHAmS5JB/5fRyxdCGaiof9Q3VvS83ToCtPj'
        'oXW4cqRIHZLbPJtayHGRZuXz1NnWKek2iy36v81PIduQYR898ePj8vJjJr/rBWc6kI9gZ3FPO3wAo7FeCK99'
        'nsmnjwL3yPP8WruKsTC+6cWe8fwM+NQxUXH+cx9NmrFYrbCdfb6wlejPfyMOjMapbbiSsZbAwPnvpBNQrv05'
        'aZjP3dcG48e80NM2s5YOVtB/Q4m9mzimb2DuiNfOrOiwNdv/amw/8TLPGG4DLHAM6J36v9KxFybk3B9zfo18'
        '1vhFSC59Of9+fjoUs5J5sWz5QMy+FJsOb+QKrd1bPDSfipgcG0Zh1nK3Y35rnjyQtt99+lgVutgbgXF6keCB'
        'b+JslZuxF5vm+MsKHdLEJSceOZt48p+YPDYSP9wPWPySxG7vlDlPypZfIitxJhHxaPKlfd8Sf0Lz8V7gO0P2'
        'NWcenKEOLP4jQQ9pSf9Uka2nec946GgXxDp+TnbxKXk5qWBOQ/aM2+yFBDxjvIWvPoMx/GJsx+u/Hm25P8s1'
        'VsvAsy5mexM2iz0phIGT/P5nkSuJ538wPIMwlxPz38nXcq1iH5mxe9eJXASZMr+NjS+llrgsikm5Hnk6SC5c'
        'Fdtpv2mJh2mAZsv6l9PAfIYan0JoDkBfO9sgd0Yr8OcGfGoxdBRXHFHRmq2Ld1Ib5rLz12JL342/vNbCOLti'
        'I5uwQQknX5K6eddTWF/7sHoaiv7WmJ5QZXJ2E1tH/NyoPoeN0PTQgy2HTwqZR2VtasdzfPxzNfr7gJLHxg69'
        '5WPoLKfFg+uqz4INFtk7Ghlh8h/V08F9ST3KfRlFstmWt78Gu41fGzGucwryrDYwN8Sjto0Gc/ZKXUIbT1Vh'
        'tpVrPGkNvYR4Q41+YuhYMy9U51Lg+GPE/ybCd3Ssck53Nc8px2Et1u+5LdKPoZF1gfih3MtDuTo+yZMSu7E+'
        'wwvOCtRbbH0gWjrCo1cvhp07Ix6c02WK+JxYMW5Nxb6PCPNPMX3ntGA7t4LnRAzr7vK0fy38prML/AhN+FFG'
        'Q8+4DjYe8c0XhG+L6ns7L9e1QJ+JYr4a4v7d0b+/K+Hr1PBAjT6TMdn9KfCC7cXa6Uac2SKRN8yUp5U6BsVA'
        'kh9uFwvGWIF/0bXWQs6soWsqbNDLWjyX0MZnUsV5iK5YDt88Pg1bek7+neKu6KzivR339mXFOoOtbZXInqe0'
        'jI0WM9n2dgndOwMms9yyFztm2GxHtGXOfEMHozGeq4AfncT4SK945xLwgzOY/bahhL6xAFhZT6DOH+prC+E/'
        'Pl0xxH7X+O9CbAqJiRIOv6+lfZ0emtSMSa8lzofo8v2APY+yrZp92ZIP9IL3f0GJM4+CPtoI9Inw/9UVZ8jK'
        'y+Ck8gwLHvPKfze5iN8V7zH4heYs7yQQn3SNRVKQDyGznGnoeh/HY8kPQzbBfYo1m3lyDhdhES4+WnfkSPfx'
        'kEnABx4F5kr+pucUe5ES5VqbhVyrD6VDY3X4/UTHv3LkRqa/vwu583ASzm9tuKuJ6W9Hn13XTOBdPU1dXNwe'
        'sJFGirO9uB5flCOxqC8Sx8tgG1F8yeeUmGqCvVxXe+bU8MD1Fvo0PpH3Mb83KfuyJ8bnaU+sPtnbpNcmaRjG'
        'XvH873/y5/+F9NPK4LtWMZtuoyWPBPd72vB/M44nWmxVotfbK26+sRw28M/hayC9eZoDb2lkWyeP9HDckzjO'
        'nK07bBn6++L8k86T3F2Mz2eB1e8tcj/a6tLqS5PgK7llK5wTocEkQ33EdH0EP/F34MMzsWSL4Wt7FLpFZtnv'
        'ppnTTsjvR5R9fxx1jgjI/8/n3ayVF8AvKO/0JmCEazyYOekWtMf/IpH3xuQH2MFjWxm8dZoY8x9GA2feHlnR'
        '2W6xxT9o4rtpzRIWthr72v4EejXnGLbDv3OIcu/GTrif/KCTUO5SnAHdLLjHtvfcRcNGPr0mxrMXdLgKdhDx'
        '54fjLfdvSls8Ve73zxQxWqnCTrFdtP9nnvJ+E++3wXEGeqt5vdrBi77giBcye9FH4T6zp31/gc+Qrkzx4Lc5'
        'sB2+V6hqyY8xFjzGxJEtTcPj9o1tvRbyi+Jaz2Qxk+s8Y3U3/MNXBJypx88h5Xsj+PMp5PW+kOe7sHmkcdgb'
        'bZc46gHgE6+JuejFWN+pyOUVB9JEGb26nWHnrljZHaDP/wL+LIr/3V6JO2UsZxGNyXzodrIdRXkR5bi0Q783'
        'cfzyHGTCLq8g3Tnd8uzUMeBdR7QglznPWOHw83K7Vdod40EHP1Hq5q5x5ue6GnxgcwE/LLuvtgO23MJhyrWS'
        'OXIpd7F9Q1VF/lV5/lcf+Ic845XOOSJ/7URPvI0rFl3mhZbPbC6Q9RIX1Z4JvgF61SzoOGRb3Voi5tC1Tzaz'
        '4CoNlm/wa5bfDT+psbhDn1+syM+yGW0jjPQt6G7VdCDHpjkDNgS3lN/nwbebifNqq+D38twrorsuz3kEMbBv'
        'oq97QLcTYQsazHkt86tuCNgrJM/4k3Kq7DjQNQXvvoHpYx849J8E+grpC3G8JY5Y5PfR8tKZ8HVeEg/wlprn'
        'LHubPW5kQCf4+VJPftp9oVN/RdxDujb50u+MBs9j6A7IHSHxFpfPRfpE5uHcPdf5FKnlfFjiDd+y5LiLoi1z'
        'HSQsluuUEny4A/WvYO2fXmD39Qn9J4LP46/Jd5a6Y1NNTGa1xRxQNqx1jmUuNiOfGY/rbsMzGy17xo1/hvMM'
        '17ldMauf872RoO26MiZhFey8xWydTlXohL5zFsZBNz/AIadii95bR24tV12vgS5eT9zzsj/m1yUT2x26Turw'
        'q4bqG82s3BmC8vd6C37JzJNnNfTZUB2V12fDhzWxEKkyTqMIW/O1uRs++FOV43wo/HVTHG2uw97tE3t1NfYg'
        'zcv1iHO5JC2OpWxF7zVnClM7H47DeTUf58vxv2+n7hxEXH+z7ampQ/8iOX+G47ySRos6f8xkF9EKxRL/uoCG'
        'U+H39GGhZk/q6sB9/WX2nBpbahWzEWoWzJ944AWWdlD/1znmqIpzAD5ZH+mgnOoFb6Z5ehZ45XEWXqr1+xif'
        'lS3PmBl7GbfA+9chfjsS+Fgjda9Nm78+ycrn4JI4nsnD+E4LPNbEeCSWs5neQlzWLLE+2vE5wdPWNoYHhvQx'
        'C7QL+Hur8Fk0cM7pKOh5i4GpkSy/26Fj+HwNl0DHuzfa0g/ej9KtWMvG7qmLMzHL5HKhMaX2bBOH8U9jJ5CN'
        'dJ5DJynCbE2ek9mwOV9FTB/55K6OBuJz6GyI81P7e0zcNc3Tz0TfT4K8+2m6dXx26+DrHe/gEZInrIZefIsD'
        'E9uoxLfjaOgZponFH7pGnIHSyuVrzzOwY+iMJ5pP0knuV+IYxOfJppvu2YPZD5tC5gTuh658guIc7UZBjJBN'
        'z5kMe+zeFv2VZq2OYbj1enae1JpA325DIaMzSywEYZCXBMa9h9LGcJ1n1BymnFSJUpbZ5HjC8g29L343a36h'
        'Qjfug+5B+sypTAfqZ7457RkNZo9aLfWfTam1U2x4ZtGZcT+DL2JKZXDt9Ch1kseRN+hssceNYpQpVv2GeDBX'
        'zAqRcyBRnGfxMu6bCZuN+MvOHr1od/hpToZvj2T7aVsJqy9Lz7FCr0vFXmbjl1uNHDqEYf6YvS9xxLRUHLaH'
        '5J9mLtZ7cnSY/eFtzJb+qOQevQqw2FBbPnbwAV/eIdm2RIFL1Bz5cLIAmb4QeYlauV4G3d/nqDdpga+6Yozb'
        'lbS9EWv6qoC9uqGxebFFVrr8UDZcuqkcE9uZMjaeaughdtDAW9B9j4cuRLzoGkduwJ6CHDhy/CuetTQh2jJ3'
        'lomtIV7xH8Qv4tb5mC2Wz+hCT7TAY7X3G5uxexjfvxY486xoMI/EXNjNNHZvC51TzrsvJ4xPjo/GOrvBsz96'
        'PjCoA8XcjQf/PwI6LrXhHqb/aXPU+HhpFLnzVcqLZC7FnFxQArvjZ0bwe8y51OsUvtTUki+L6xUuvFfqaVKn'
        'GgEZNZ/lRXnFkk/pQ/gm+rAe/pC5bVvb95qIYVuJOJT/ErRnO+My9eR22wyM4ZoW8oia9tFYzEqLMXCtDIot'
        'OLnNJ74ndJKY0YlLP5H+HuK/uwX6DCaxuW0U5PMnXj/f8771sAl+ZPG3Uj82BfoI6Bpl5Framh9c8+zx6Mej'
        'AfG3DZyRJuea+NWXAnhSiO/AhqfJdy4R5/e1QZc29a2y7E8nG/sI9o66JcZmGTtzpw8+Rlt7m57zO4rO9U4V'
        '+w6alhiesfCD+Phkm7CFZb0ToYNSHylm+puE7QAUJlxoI8N7NyjiaU1cv1nLLj+g0cmqDtlUxo4zOuGmYdpf'
        'mVn2vFAsyf2RPY+l5KlmzY+IBnMaSHtqMuTwg0JPMHxztFLOdmOMb2sBI8oUZ0jZ7qc+3ZQNH2Zr8NCFynOd'
        'TJzWC1thnwLdczTwhrkV+/NLLDqMyblsG9taAbaTirPg+f/qkHtkD8wAfTSxb9lnRzQscXFEu1+Jtszr4vKb'
        'V6GzEPZ7NtNbaiXyDLjuj0vqGw2Hr62M7WBskAXIhbxJnIHletb4dnaLivcL2HLRaPiSidvr8ayFsdBxtivB'
        '9zowp+sduEETuuknZ5Fb9EMZA+wbZyMbPoYMmI9c4eMxjo/BV0P64d2VgTZNh60rcXqJMTYCfd+2vdJSH6iU'
        'sD1t8d4Js+PqHr1rLXjaBYFroenYy2DzN8m51siLkLgsYz+NA1YyxuHraSLXAtHtxXG4rHDhPa65dvEKLX82'
        'Ml2zvnZF3+8O7EsMvxzlHJ2hyO9dBm/hNJmxOIAYuvOlFt8Tv8fM7wewidssY1Vj50Sbfo3CnL/C1m/NkhPY'
        'hpObM7amFeiArr3hNl30NdhyJ0T2WHe6lsHn8ZAjzipT+PukzGqFzk3fvtdCfIUGD2xgvtsjd44R13vGREPP'
        'SQnVDU4U9aaWvXIUE313ACbG5a8NryY7lvIBX1sJW18+vGIV9jbsLe4hPfHKaOiZ2iHj5vPf/T+mIhfw'),
    "cost_of_initial": (
        'eNrtW9tOwzAMnZ2Ubh2bNpAQSDzyqXwcn4V4QEJVmziObx3LCyA1zonPsWMnYrdrGzD72TKQ+N1Lg81UwDnt'
        'tjEmhv+lv5WYh8S5KLBWDfea3SzECyjoAALY4+jrTTAPSGCGjcQ9OnO9tv4YzE85CI5jh38hgM5AMQf8/r42'
        '94uIMwnwf2rYEyzEgTVXYJA3wBBf6zgr4urFPgTKg2DAUzLEDoHqKGDYOhJzLirGNYVLEFiv9m1W5BCUfQeV'
        'mgcUdK9ZL0rkiUTklZIfe7WRhbno0cpoFLvRe5I9oV/+nP19CFhLWWCZCNgkfZM6/YVOdWZ0jiFIj/q4gAkY'
        'GkgbjClqvyfBdUscjQs+1fTb2Smm1u4SWntoK01dldf0iA3tNTGIHe37Ksr8B8HatVYvWXM6v58cnHSNHfyC'
        'YxxuvT71GLlQg7Te50EhZoc/Z3JLHkrMOvrOeX88r8VydsTqwWlasD8Z6qnV/kWZC2D60Jo/FMYYJZe0vGMC'
        'w8aegScZ7h8U+JDmcerQZHL0X8u8QTkewZg/MK5hoWMvXu/HoNif3kccTilx/ky0f2TqJQvcP/Rqc5jlZWmt'
        'D4R7Dcuz9SCgL8t8gEHjC4lcTgbxLem36z/LqZJncelN8bVifzDivWW/3PvgtJHcwvER3ojuS+dw7XyXrnW9'
        'eu+Tc58frVfm9GNZIEaSELale7zRSXcYSAfcWrP0dpcC+2JrfVpWxrMX5CoJ4OnJS9Z3RhLcr/n0wwjLewGf'
        'VWyORjz96PPpRnrSKEP7/3XQISZ7c5L1njTfxrl9HgTSpIUtSq1ds/UNKQQFZg=='),
    "rosenbrock": ([0.9999999960320636, 0.9999999920475379], 7.886019977753385e-18, 17),
}
# scripts/covariance16_golden.py: the JAX package's BAL-16 DENSE_SCHUR solve
# (final cost, rows) and its QR's 135 x 135 variable-camera covariance: the
# diagonal and the products with two default_rng(0) normal vectors. The JAX
# Schur tail's and normal equations' digests are within 2.0e-13 and 4.4e-13
# of these (relative to the largest entry), so every port path is held to
# them
COV16_GOLDEN = {
    "solve": (1318740.8947217267, 6),
    "digest": (
        [
            2.1600285956570057e-08, 2.702610352658657e-08, 1.4338285601496797e-08,
            1.4220472567565354e-07, 1.188350151032991e-07, 2.5362459142352758e-05,
            0.06242866679040943, 5.559032747643974e-07, 4.0670002560070745e-08,
            3.441189877368651e-08, 2.62752849249448e-08, 1.622947632629078e-08,
            1.3444379449390685e-07, 1.9903506869690649e-07, 2.9246497443179998e-05,
            0.06819735262109923, 1.1525153062693777e-06, 3.3121643916102993e-07,
            2.361391217968365e-08, 2.221945672972024e-08, 1.301355615411466e-08,
            1.1588103100881504e-07, 1.275378142857903e-07, 1.7025777338005197e-05,
            0.054372810125325154, 9.533175211116968e-07, 4.484736696124671e-07,
            3.9577757617305645e-08, 2.4508405559277793e-08, 1.685184441835899e-08,
            1.200587379467215e-07, 2.2532490089995625e-07, 3.126163522746615e-05,
            0.07871120891500033, 2.642170495682027e-06, 2.8372790813107215e-06,
            2.020999948043083e-08, 2.2001850085033607e-08, 1.3042566656939173e-08,
            1.1216404488114484e-07, 1.1903042395226415e-07, 1.5382506615086744e-05,
            0.0406019307063416, 2.4860821782838355e-07, 9.144474507753488e-10,
            2.3445477384770883e-08, 3.030115414727191e-08, 1.4026893050106657e-08,
            1.745867997685149e-07, 1.2158305427215732e-07, 1.929204687599369e-05,
            0.056280581151773645, 5.341652453678095e-07, 1.4638119155974414e-07,
            2.6650165357191342e-08, 1.9140368295201917e-08, 1.2998865346732462e-08,
            1.0170110834801147e-07, 1.5660273115776054e-07, 1.6254216013124387e-05,
            0.05208508708533411, 4.7645584218663706e-07, 7.80204937324949e-08,
            2.488374937884551e-08, 2.5060779732254964e-08, 1.3757290133696203e-08,
            1.2855684142277049e-07, 1.314969214584645e-07, 2.179575834019292e-05,
            0.061047673021803944, 8.638873029935507e-07, 3.441605551576278e-07,
            2.5494098023492295e-08, 2.158729294851612e-08, 1.3608349241175902e-08,
            1.1273302033090713e-07, 1.5266780471994926e-07, 2.0838244119625294e-05,
            0.056844969896369724, 1.3706620036741243e-06, 8.110808602008766e-07,
            2.9185185035280334e-08, 2.0709548358115898e-08, 1.377052359329622e-08,
            1.0880223291150064e-07, 1.6926957867209127e-07, 1.635447550211129e-05,
            0.04833498839331189, 1.0760760506870338e-06, 4.99851290503382e-07,
            2.2221005639319487e-08, 2.2655217887675378e-08, 1.262826706456084e-08,
            1.1757149529545863e-07, 1.1193477032644422e-07, 1.6016979998562356e-05,
            0.04517721947462887, 5.589610885728371e-07, 8.06563557356778e-08,
            2.7335117712779112e-08, 2.078923308491661e-08, 1.4001673782527527e-08,
            1.0862977293737791e-07, 1.6020598109024692e-07, 1.7319772311081076e-05,
            0.05378451605252136, 8.728113176818358e-07, 4.2808230610461085e-07,
            2.471639441704659e-08, 2.7240202256881574e-08, 1.3656648842638404e-08,
            1.4225351873847987e-07, 1.31347585249537e-07, 1.7229228242834545e-05,
            0.0555529328534923, 8.345783366488434e-07, 3.2044219513896396e-07,
            2.348046843545367e-08, 2.109581954009208e-08, 1.227027519628072e-08,
            1.093528896577555e-07, 1.226392692279504e-07, 1.5610085359482095e-05,
            0.0496994216838338, 7.441086039395652e-07, 2.8292460383762994e-07,
            2.4593278224138576e-08, 2.7754581027163594e-08, 1.4394560842527028e-08,
            1.4917771359515807e-07, 1.3042293722869515e-07, 2.2184549959904158e-05,
            0.060181277575479836, 1.4559945493785976e-06, 8.600502639964459e-07,],
        [
            [
                -6.703374135853049e-06, 1.8036267964797078e-05, 7.122793598444838e-07,
                1.2465673698369422e-05, 8.47947825423925e-06, -0.0025842571923233777,
                -0.13600279433484447, -0.00013690940140667306, -1.593082826289059e-05,
                -1.2630765102079739e-05, 4.671829837242152e-06, -1.3189895216394967e-06,
                4.700878124196672e-06, 1.0727989952605334e-05, -0.0016556041276524173,
                -0.0865558800305462, -6.140280628863364e-05, -1.7095941541129113e-06,
                8.985700043400968e-06, -1.27919308335838e-06, -2.5164417719122077e-07,
                5.625903972967976e-08, -5.7749948737907765e-06, 0.0009994134455213867,
                0.06587785015454886, -4.7853115855294465e-05, 9.476935555855307e-05,
                7.060208673234365e-06, 4.91312487619551e-07, -3.263922327952512e-07,
                5.981109881180587e-07, -6.800250973978844e-06, 0.0016345349828172566,
                0.09377149210468329, -0.00010629974454180141, 0.00020937310786725243,
                -2.9841152225609784e-06, -4.048889497189405e-06, -1.0436446093587594e-07,
                1.8447049389115566e-07, 5.249867989532942e-06, -0.0009334647993644273,
                -0.05252997525303886, -4.936204735725237e-05, 8.102747373302531e-07,
                -4.438455729161227e-06, -5.409152476366865e-06, -1.283827633914773e-06,
                -4.070766006767087e-06, 3.88802204960786e-06, -0.000534194390672395,
                -0.03210683645507334, -5.919529126558341e-06, -1.8755363936298526e-05,
                -6.373884606030038e-07, 1.6284408666267914e-06, -3.2080832777369847e-07,
                1.7104319874053648e-06, 5.244916662302215e-06, 0.00010705292241537334,
                0.007971227788689639, -2.352989623537586e-05, 2.7503050092400704e-05,
                -3.0713917425452985e-06, -1.4805362916630099e-05, 2.3659574723215888e-07,
                -1.3996110570171138e-05, 3.805295714495291e-06, -0.00246374300592896,
                -0.14030454135358827, -1.760649002687102e-05, -0.00011083451451223789,
                1.9031197013368703e-06, -1.197378108454769e-06, -8.414734255093217e-07,
                4.1506113591752404e-07, -8.32443162669805e-07, -4.829052268636454e-05,
                -0.0028840677096214525, 2.7016690187046767e-06, -2.117053887259622e-06,
                2.1527513062780175e-06, 1.6890726657171823e-06, -5.152356885754872e-07,
                2.8321938745091864e-07, -7.843369362550672e-07, 0.00022643261847175996,
                0.01544400136969885, -2.2893163064824046e-05, 2.9129622439167572e-05,
                -1.5891115709096305e-07, 3.3620952307358904e-07, -5.880516863718782e-07,
                -1.6726376213390475e-06, 4.681063940636192e-07, 0.00026282355383249557,
                0.01570784613344996, 8.62364082109354e-06, -1.9280818682328876e-07,
                2.3076518609576985e-06, -1.7744078873444539e-07, -4.06527558820016e-07,
                3.3044406297403877e-07, -3.14078954546142e-06, -9.604547591346985e-05,
                -0.002818467462541726, -5.005752582929774e-05, 4.7922881354793e-05,
                2.876382185319275e-06, 4.15484886376416e-06, 1.8268947379389854e-07,
                3.4474312392458633e-06, -1.852096498650723e-06, -0.0006877187323354279,
                -0.042326314149318915, -2.415881382329254e-05, -9.353461041447266e-06,
                1.197426702280207e-06, 1.1674656055881097e-06, -7.531628709542349e-07,
                2.036903338982438e-06, -5.316970758684269e-07, -0.0006782059524267065,
                -0.04167167912683891, -2.6048298709416786e-05, -5.132406787880316e-07,
                2.9785118021690654e-06, -8.389397804564758e-08, -1.8628766641887569e-06,
                -6.278950112851e-07, -1.5510229692659392e-06, -0.0003092825808606489,
                -0.016924061962552445, -1.5797884611147763e-05, -7.124743347218243e-06,],
            [
                3.4279564038636936e-06, -1.3650461261821497e-05, 6.239419174543221e-07,
                -8.679096269447313e-06, -4.783226679542268e-06, 0.0016362161593417436,
                0.08889802187948777, 6.724659355439025e-05, -8.340651279547726e-07,
                1.989840673305116e-05, 3.026581856705044e-06, -1.486597029491665e-07,
                3.09968143775679e-07, -1.2794996616778034e-05, 0.0015454942926988028,
                0.08347143366485729, 2.7873221124485715e-05, 3.611038505871019e-05,
                6.965198204017652e-06, -1.42778417629817e-05, -4.6001871246356316e-08,
                -8.731763527451914e-07, -9.122418619705271e-06, 0.0026446400060444663,
                0.16040662291818678, 5.404180429569018e-05, 8.966774424144027e-05,
                -4.402334683791077e-06, 2.2120758996267406e-07, 1.0941058551138791e-06,
                3.5722682999325117e-06, -9.358813612431224e-06, 0.0036327350215399753,
                0.19604587296320586, 2.1695857010633806e-06, 0.00021465652330384158,
                7.811350747179685e-06, 1.6050831173510858e-06, -7.354622795365725e-07,
                5.581419912600712e-06, -9.31177346337538e-06, 0.0020610696091408445,
                0.11119090078681931, 0.00012827679728573345, -4.747001062662369e-06,
                9.814539451338949e-06, 1.8843932462459303e-05, -6.442165111023913e-07,
                9.910308900542483e-06, -4.934933594141908e-06, 0.000927651596538231,
                0.05386392333711494, 4.140434160084428e-05, -2.5557759882282236e-06,
                2.4398484822492648e-05, 1.2351440815188211e-05, -9.019198226699548e-07,
                1.1745991229489993e-05, -7.089203169340404e-06, 0.0019687199098040774,
                0.12027798715283154, 8.213959849231093e-05, 7.723372245702663e-06,
                1.062407166577943e-05, 2.2544917651520997e-05, -1.2298511441651705e-06,
                2.0030151837219894e-05, -3.641144669137412e-06, 0.002793125982854634,
                0.15867525896672213, 4.253638327214926e-05, 8.647439828169307e-05,
                -1.3894066852189511e-05, 9.337671113614897e-06, 7.569229366970864e-07,
                1.1374601625095518e-05, 8.215299395716259e-06, 0.001776633953904859,
                0.10124074375063906, 5.005250214943169e-05, 4.5477743845711804e-05,
                -1.920052609233699e-05, 8.800207471766152e-06, 4.208015705283465e-07,
                1.083967964970448e-05, 1.0664881262412211e-05, 0.0017276023605946995,
                0.09925466374358131, 6.640538825152858e-05, 1.746480965262674e-05,
                -8.18177734455496e-06, 9.284075668180673e-06, -3.60896891413942e-08,
                8.135070934437089e-06, 6.976221373714828e-06, 0.001607362983850108,
                0.09416426855111464, 5.310905871557064e-05, 1.7774714460811083e-05,
                -2.6228553602519373e-05, 3.412012252207932e-06, 4.64171834443235e-07,
                1.6069180880325826e-06, 2.3462739138406947e-05, 0.003337445409159189,
                0.20075302693668298, -2.139556234411459e-05, 0.0001766472800118932,
                6.790516916558844e-06, -1.4692030324975291e-05, 7.24077707607358e-08,
                -3.850196394462144e-06, 9.656963380497259e-07, 0.0009117050938464436,
                0.05572325310924823, 2.0554426182777965e-05, 1.8123668301198912e-05,
                3.1189940739177365e-07, -6.533922374085953e-06, -4.186419623726213e-07,
                -7.31586519784994e-06, 9.794394409503055e-06, 0.0030494831344304715,
                0.18997864571045928, 7.78397515512142e-05, 4.5134737477510577e-05,
                -1.0656476042874902e-05, -6.010612419377356e-07, -8.57908128223286e-07,
                -3.781581729656692e-06, 8.738488328373437e-06, 0.002483531893603864,
                0.13946989777613214, 4.867852327133663e-05, 6.472799084730922e-05,],
        ]),
}
NIST_GOLDEN = {
    'Misra1a': [0.06647540342411101, 0.06647540342411644],
    'DanWood': [0.00019793938663888595, 0.00019793938663887454],
    'Lanczos3': [1.6315627097921691e-10, 1.6315627098006894e-10],
    'Rat42': [0.021114386290802433, 0.02111438629080212],
    'Eckerle4': [4.021679662772893e-08, 4.0216796627730125e-08],
}
DENOISE_GOLDEN = {"rows": [
    431562.58317104273,
    186907.96017477138,
    87182.27673208609,
    59946.98949321753,
    52398.53657143663,
    49760.255320577715,
    48682.475144667216,
    47987.3527649889,
    47630.14239091113,
    47355.000038572216,
    47178.783365068346,
    47025.41726515547,
    46896.42285821621,
    46786.92984894953,
    46717.17661463896,
    46668.45099969786,
    46639.34490220223,
    46612.08186531421,
    46592.95115462536,
    46577.541982065144,
    46565.27560171059,
],
                  "cg": [0, 10, 23, 39, 40, 34, 14, 39, 14, 39, 14, 35, 13, 37, 15, 44, 21, 42, 17, 43, 21]}
# the denoising rows held to the JAX rows: all of them (the CPU port's are
# within 6.6e-12 of the JAX rows, the same CG counts, no row parts)
DENOISE_ROWS_HELD = 21


def write_nist_file(path, name, seed=0):
    """Writes a problem of NIST_SHAPES[name] in the StRD .dat layout that
    models/nist.parse_nist_file reads: responses the model at its
    parameters times (1 + noise N(0, 1)) from default_rng(seed); as
    certified values the least-squares minimum by scipy's
    Levenberg-Marquardt from the model's parameters, and its residual sum
    of squares."""
    from scipy.optimize import least_squares

    from ceres_tpu_torch.models import nist

    model_name, truth, x, starts, noise = NIST_SHAPES[name]
    model = getattr(nist, model_name)

    def f(b):
        return model(torch.as_tensor(b, dtype=torch.float64), torch.as_tensor(x)).numpy()

    y = f(truth) * (1.0 + noise * np.random.default_rng(seed).standard_normal(len(x)))
    cert = least_squares(lambda b: y - f(b), np.asarray(truth), method="lm",
                         xtol=1e-15, ftol=1e-15, gtol=1e-15).x
    rss = float(np.sum((y - f(cert)) ** 2))
    p = len(truth)
    lines = ["NIST/ITL StRD format (synthetic)", f"Dataset Name:  {name}"] + [""] * 22
    lines += ["Data:          1 Response Variable  (y)",
              "               1 Predictor Variable (x)",
              f"               {len(x)} Observations"] + [""] * 4
    lines += [f"               {p} Parameters (b1 to b{p})"] + [""] * 8
    lines += [f"  b{i + 1} = " + "  ".join(repr(float(st[i])) for st in starts)
              + f"  {float(cert[i])!r}  0.0" for i in range(p)]
    lines += ["", f"Residual Sum of Squares:   {rss!r}", ""]
    lines += [""] * (60 - len(lines)) + ["Data:   y               x"]
    lines += [f"  {float(a)!r}  {float(b)!r}" for a, b in zip(y, x)]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def write_foe_file(path, num_filters=3, seed=0):
    """Writes a 2x2 Fields-of-Experts model in the layout that
    models/denoising.read_foe_file reads (size, filters, x and y offsets,
    alphas, filter coefficients): zero-mean filters of unit norm and
    alphas in [0.5, 1.5] from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    filters = rng.standard_normal((num_filters, 4))
    filters -= filters.mean(axis=1, keepdims=True)
    filters /= np.linalg.norm(filters, axis=1, keepdims=True)
    alpha = rng.uniform(0.5, 1.5, num_filters)
    words = ["2", str(num_filters), "0 1 0 1", "0 0 1 1", " ".join(repr(float(a)) for a in alpha)]
    words += [" ".join(repr(float(v)) for v in row) for row in filters]
    with open(path, "w") as fh:
        fh.write("\n".join(words) + "\n")


def noisy_image(size=256, sigma=20.0, seed=0):
    """A size x size 8-bit image (smooth shading and a checkerboard) with
    N(0, sigma^2) noise from default_rng(seed), rounded and clipped as a
    PGM holds it."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    clean = (108.0 + 60.0 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
             + 40.0 * ((xx // 32 + yy // 32) % 2))
    noisy = clean + sigma * np.random.default_rng(seed).standard_normal(clean.shape)
    return np.clip(np.round(noisy), 0, 255)


def triangulations(n, seed=0):
    """n independent triangulation problems for TinySolver (port slice
    18): a point X ~ N((0, 0, 5), 0.5^2 I), seen by 4 cameras (an
    angle-axis rotation N(0, 0.1^2) per coordinate and a translation
    N(0, 1), the last coordinate 0), each observation the exact projection
    (R X + t)[:2] / (R X + t)[2]; the start X + N(0, 0.1^2). Lane i's draws
    are row i of one (n, 30) standard normal array from default_rng(seed),
    so the first lanes do not depend on n. Returns (truth (n, 3), start
    (n, 3), cameras (n, 4, 6), observations (n, 4, 2)), float64."""
    g = np.random.default_rng(seed).standard_normal((n, 30))
    X = 0.5 * g[:, 0:3] + np.array([0.0, 0.0, 5.0])
    aa = 0.1 * g[:, 3:15].reshape(n, 4, 3)
    t = g[:, 15:27].reshape(n, 4, 3).copy()
    t[..., 2] = 0.0
    x0 = X + 0.1 * g[:, 27:30]
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    w = aa / theta
    Xb = np.broadcast_to(X[:, None, :], aa.shape)
    ct, st = np.cos(theta), np.sin(theta)
    p = (Xb * ct + np.cross(w, Xb) * st
         + w * (np.sum(w * Xb, -1, keepdims=True) * (1.0 - ct)) + t)
    return X, x0, np.concatenate([aa, t], -1), p[..., :2] / p[..., 2:3]


def triangulation_residual(rot):
    """The reprojection residual (8,) of one point x (3,) over its data
    (cameras (4, 6), observations (4, 2)), with `rot` the port's or the
    JAX package's rotation module."""
    def residual(x, d):
        cams, obs = d
        p = rot.angle_axis_rotate_point(cams[:, :3], x[None, :]) + cams[:, 3:]
        return (p[:, :2] / p[:, 2:3] - obs).reshape(-1)
    return residual


def unpack_ints(text, dtype):
    """The integer array that scripts/tiny_solver_golden.py packed."""
    import base64
    import zlib

    return np.frombuffer(zlib.decompress(base64.b64decode(text)), dtype).astype(np.int64)


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


def covariance_gauge(b):
    """The points the covariance phase holds constant on a BAL problem
    (port slice 18): point 0, which with camera 0 fixes the 7-dof gauge,
    and every point fewer than three cameras see. A point one camera sees
    has no depth along its ray (J loses a column's rank to each: at BAL-16
    1,720 of them, and every covariance path returns False, the JAX
    package's pure QR after 25 minutes of ordering on a CPU); after the
    DENSE_SCHUR solve a two-view point of BAL-16 leaves R a squared pivot
    1.7e-15 of the largest, under min_reciprocal_condition_number's 1e-14.
    Without both kinds, 1.7e-10: 17k points stay variable."""
    seen = np.bincount(b.point_index, minlength=b.num_points)
    return np.union1d([0], np.flatnonzero(seen < 3))


def anchored_problem(ctt, bal, b, w=1e-2):
    """Phase (b) of the covariance phase: b built one block at a time
    (bal.build_problem) with a Tikhonov anchor of weight w on every camera
    and point at its start (the JAX Schur-tail tests' gauge,
    tests/test_satellite_apis.py:368-374). Returns (problem, cameras,
    points)."""
    p, cams, pts = bal.build_problem(bal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    anchor_c = ctt.AutoDiffCostFunction(lambda c, d: w * (c - d), 9, [9])
    anchor_p = ctt.AutoDiffCostFunction(lambda q, d: w * (q - d), 3, [3])
    for blocks, cost in ((cams, anchor_c), (pts, anchor_p)):
        for v in blocks:
            p.add_residual_block(cost, None, [v], data=v.copy())
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


def values_of(problem):
    """Copies of a Problem's parameter values, to put back in place before a
    repeated solve (a solve writes its answer into them)."""
    return ([a.values.copy() for a in problem.parameter_block_arrays()],
            [b.values.copy() for b in problem.parameter_blocks()])


def restore_values(problem, saved):
    arrays, blocks = saved
    for a, v in zip(problem.parameter_block_arrays(), arrays):
        a.values[...] = v
    for b, v in zip(problem.parameter_blocks(), blocks):
        b.values[...] = v


def reused(problem_fn):
    """problem_fn's Problem, built once: each call puts its starting values
    back and returns it, so repeated solves (a profile's) reuse its
    compiled program and plans (CompiledProgram.cached)."""
    problem = problem_fn()
    saved = values_of(problem)

    def again():
        restore_values(problem, saved)
        return problem
    return again


def fresh(lp):
    """A copy of a LibmvProblem whose arrays a solve may write into."""
    import dataclasses

    return dataclasses.replace(lp, cameras=lp.cameras.copy(), points=lp.points.copy(),
                               intrinsics=lp.intrinsics.copy())


class SmokeFailure(Exception):
    pass


_BAL16 = {}


def bal16(bal):
    """A fresh copy of BAL-16's arrays (models/bal.bal16, bench.py:_bal16),
    generated once (~1 s on the host each time): a solve writes its answer
    into the cameras and points of the problem it was given."""
    if "b" not in _BAL16:
        _BAL16["b"] = bal.bal16()
    b = _BAL16["b"]
    return bal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
                          b.point_index.copy(), b.observations.copy())


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


def main(argv=()):
    import argparse

    ap = argparse.ArgumentParser(description="The port's smoke run on the card.")
    ap.add_argument("--phase", choices=("all", "mesh"), default="all",
                    help="mesh: build the kernels and run only the mesh phase")
    ap.add_argument("--cards", type=int, choices=(2, 4), default=0,
                    help="add the NCCL group of this many ranks, one per card, and "
                    "BAL-16 solved on cuda:1 in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} cards, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
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
    paths = {}

    # -- the mesh phase (port slices 19 and 20) --------------------------------
    log("phase", f"the mesh tiers from {time.monotonic() - t_start:.1f} s")
    log("phase", f"the mesh tiers took {mesh_phase(bal, kn, card, paths, args.cards):.1f} s")
    if args.cards:
        second_card_solve(ctt, bal, kn, card, paths)
    if args.phase == "mesh":
        log("total", f"chip_smoke --phase mesh ran {time.monotonic() - t_start:.1f} s")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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
    b16 = bal16(bal)
    log("bal16", f"cameras {b16.num_cameras}, points {b16.num_points}, "
        f"observations {b16.num_observations}")
    rng = np.random.default_rng(7)
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(bal.build_problem_batched(bal16(bal))[0], dtn,
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
        finite, falling over successful steps) and two more solves of the
        same Problem, its values put back in place, which must repeat it
        bit for bit and time the same work: they reuse its compiled
        program and fused minimizer (CompiledProgram.cached). Logs the
        set-up outside the solves (building the Problem) and the repeats'
        time to the first iteration."""
        t0 = time.monotonic()
        problem = problem_fn()
        build_s = time.monotonic() - t0
        saved = values_of(problem)
        s, res = drive(path, opts, problem, flat=flat, variant=variant,
                       kernels=kernels)
        res["problem_build_s"] = build_s
        costs = [r.cost for r in s.iterations]
        check(all(np.isfinite(c) for c in costs), f"{path}: a cost is not finite")
        accepted = [s.iterations[0].cost] + [
            r.cost for r in s.iterations[1:] if r.step_is_successful]
        check(len(accepted) >= 2 and all(b < a for a, b in zip(accepted, accepted[1:])),
              f"{path}: the cost did not decrease over successful steps: {accepted}")
        cg = sum(res["linear_solver_iterations"])
        res["cg_iterations_per_lm_iteration"] = cg / max(res["iterations"], 1)
        minimizer_s = [res["minimizer_s"]]
        res["repeat_preprocessor_s"] = []
        for _ in range(2):
            restore_values(problem, saved)
            s2 = ctt.solve(opts, problem)
            torch.cuda.synchronize()
            check([r.cost for r in s2.iterations] == costs,
                  f"{path}: a repeated solve differs")
            minimizer_s.append(s2.minimizer_time_in_seconds)
            res["repeat_preprocessor_s"].append(s2.preprocessor_time_in_seconds)
        del problem, saved
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
            f"{res['preprocessor_s']:.3f} s (the repeats' on the cached program "
            f"{', '.join(f'{v:.3f}' for v in res['repeat_preprocessor_s'])} s; building "
            f"the Problem {build_s:.3f} s outside the solves), peak device memory "
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
        card's may be either. With no `ulp_problem_fn` the one-ulp solve is
        not run: each row within 1e-9 and the same CG counts. `solver` as
        drive's."""
        s_card, _ = drive(path, opts, problem_fn(), flat=flat, kernels=kernels,
                          solver=solver)
        t0 = time.monotonic()
        s_cpu = (solver or ctt.solve)(opts, problem_fn(), device="cpu")
        cpu_s = time.monotonic() - t0
        rows_card = [(r.linear_solver_iterations, r.cost) for r in s_card.iterations]
        rows_cpu = [(r.linear_solver_iterations, r.cost) for r in s_cpu.iterations]
        if ulp_problem_fn is None:
            rows_ulp = rows_cpu
        else:
            s_ulp = (solver or ctt.solve)(opts, ulp_problem_fn(), device="cpu")
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
                       bal.build_problem_batched(bal16(bal))[0])
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
        s, res = drive(path, opts, bal.build_problem_batched(bal16(bal))[0])
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
            s = ctt.solve(opts, bal.build_problem_batched(bal16(bal))[0])
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
        same = reused(lambda: bal.build_problem_batched(bal16(bal))[0])
        paths[path]["profile"] = profile_solve(lambda: ctt.solve(opts, same()))
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
        same = reused(lambda: libmv.build_problem(fresh(lp16))[0])
        paths[path]["profile"] = profile_solve(lambda: ctt.solve(opts, same()),
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

    # -- the sparse direct solvers ------------------------------------------------
    log("phase", f"the sparse solvers from {time.monotonic() - t_start:.1f} s")
    t_sparse = time.monotonic()
    sparse_phase(ctt, bal, libmv, kn, dev, card, paths, drive, card_against_cpu,
                 check_and_time, lp16, ulp16)
    log("phase", f"the sparse solvers took {time.monotonic() - t_sparse:.1f} s")

    # -- the preconditioners and Schur options of ITERATIVE_SCHUR ------------------
    log("phase", f"the preconditioners from {time.monotonic() - t_start:.1f} s")
    t_precond = time.monotonic()
    precond_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu, check_and_time)
    log("phase", f"the preconditioners took {time.monotonic() - t_precond:.1f} s "
        "(their Venice run comes in the Venice phase)")

    # -- the line search, inner iterations, GradientProblem, the cache ----------
    log("phase", f"the line search and inner iterations from "
        f"{time.monotonic() - t_start:.1f} s")
    t0 = time.monotonic()
    line_search_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu)
    cache_check(ctt, "bal16_dense_f64", ctt.Options(linear_solver_type=DS),
                lambda: bal.build_problem_batched(bal16(bal)), card)
    log("phase", f"the line search and inner iterations took "
        f"{time.monotonic() - t0:.1f} s")

    # -- the example scripts ------------------------------------------------------
    log("phase", f"the examples from {time.monotonic() - t_start:.1f} s")
    log("phase", f"the examples took {examples_phase(kn, card, paths):.1f} s")

    # -- port slice 18: covariance, TinySolver, capi, rotation, NIST, denoising ----
    log("phase", f"slice 18 from {time.monotonic() - t_start:.1f} s")
    log("phase", f"slice 18 took {satellite_phase(ctt, bal, kn, dev, card, paths):.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

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
        same = reused(lambda: copy_problem(venice))
        paths[path]["profile"] = profile_solve(lambda: ctt.solve(opts, same()))
        del same
        log(f"profile {path} (2 LM iterations)",
            json.dumps(paths[path]["profile"]) + f"; {card}")
        log_row_passes(path, paths[path]["profile"], card)

    # -- CGNR + JACOBI at the Venice shape, float32: row 4 at 4.4M rows ------
    path = "venice_cgnr_f32"
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.CGNR,
                       evaluation_dtype="float32", max_num_iterations=VENICE_LM_ITERATIONS)
    large_solves(path, opts, lambda: copy_problem(venice), kernels=CGNR_PATH)
    same = reused(lambda: copy_problem(venice))
    paths[path]["profile"] = profile_solve(
        lambda: ctt.solve(dataclasses.replace(opts, max_num_iterations=2), same()),
        anchor=SEGMENT_SUM_ANCHOR)
    del same
    log(f"profile {path} (2 LM iterations)", json.dumps(paths[path]["profile"])
        + f"; normal_matvec (row 4) launches in the 5-iteration solve "
        f"{paths[path]['launches']['normal_matvec']} for "
        f"{sum(paths[path]['linear_solver_iterations'])} CG iterations; {card}")
    log_row_passes(path, paths[path]["profile"], card)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the host loop at the Venice shape through a logging callback -----------
    host_loop_venice(ctt, bal, card, paths, large_solves, lambda: copy_problem(venice))

    # -- the power series at the Venice shape (the precond phase's) --------------
    t0 = time.monotonic()
    precond_venice(ctt, card, drive, lambda: copy_problem(venice))
    log("phase", f"the preconditioners' Venice run took {time.monotonic() - t0:.1f} s")

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
    # (e) at libmv-Venice: the time to the first iteration of a first and a
    # repeated solve (2 LM iterations, float32)
    cache_check(ctt, "libmv_venice_iterative_f32",
                ctt.Options(linear_solver_type=IS, evaluation_dtype="float32",
                            max_num_iterations=2),
                lambda: libmv.build_problem(fresh(lpv)), card)
    opts = ctt.Options(linear_solver_type=IS, evaluation_dtype="float32",
                       max_num_iterations=2)
    same = reused(lambda: libmv.build_problem(fresh(lpv))[0])
    paths["libmv_venice_iterative_f32"]["profile"] = profile_solve(
        lambda: ctt.solve(opts, same()), anchor=SEGMENT_SUM_ANCHOR)
    del same
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
        shp = next((p for p in ("libmv_venice", "libmv16", "venice", "bal16")
                    if path.startswith(p)), None)
        if shp is None:  # the pose graphs: no kernel timed at their shapes
            untimed[path] = [k for k, n in res["launches"].items() if n]
            continue
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


def satellite_phase(ctt, bal, kn, dev, card, paths):
    """Port slice 18 on the card: (a) Covariance at BAL-16 (built one block
    at a time, camera 0 and the points of covariance_gauge constant,
    solved with DENSE_SCHUR) over the 15 x 15 variable camera pairs by the
    pure QR, the Schur tail (schur_tail_min_cols=128: S on the card) and
    the normal equations, each against the JAX package's digest
    (COV16_GOLDEN, scripts/covariance16_golden.py) and the others; (b) the
    400-camera core (COV400) at the default options (the Schur tail), card
    against CPU and against the normal equations, COV400_BLOCKS camera
    blocks; (c) TinySolver.solve_batch on TINY_LANES triangulations, the
    first TINY_GOLDEN_LANES against the JAX solve_batch (TINY_GOLDEN,
    scripts/tiny_solver_golden.py) and the port's CPU, and Rosenbrock by
    solve; (d) the capi surface and the five rotation functions of the
    slice, card against CPU; (e) examples/nist.py on NIST_SHAPES written to
    files and examples/denoising.py on a DENOISE_SIZE image and an FoE
    model written to files, against NIST16_GOLDEN and DENOISE_GOLDEN
    (scripts/nist_denoising_golden.py). Each run's launches are counted
    from 0; no plain version runs on the card. Returns the phase's
    seconds."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from ceres_tpu_torch import capi
    from ceres_tpu_torch import rotation as rot
    from ceres_tpu_torch.examples import denoising as den_example
    from ceres_tpu_torch.examples import nist as nist_example
    from ceres_tpu_torch.models import denoising

    t_phase = time.monotonic()
    DS = ctt.LinearSolverType.DENSE_SCHUR

    def counted(path, fn, on_card=True):
        """fn() with the counts set to 0 just before it and read just after:
        (its value, launches, wall seconds); no plain version runs in a run
        on the card, no kernel in one on the CPU."""
        kn.reset_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches, plain_calls = counts(kn)
        check(not any((plain_calls if on_card else launches).values()),
              f"{path}: a {'plain version' if on_card else 'kernel'} ran: "
              f"{plain_calls if on_card else launches}")
        return out, launches, wall

    def record(path, launches, wall, **kw):
        paths[path] = dict(iterations=kw.pop("iterations", 1), launches=launches,
                           wall_s=wall, **kw)
        log(f"slice18 {path}", json.dumps(paths[path], default=str) + f"; {card}")

    # -- (a) covariance at BAL-16 -------------------------------------------------
    b16 = bal16(bal)
    p, cams, pts = gauge_fixed_problem(bal, b16)
    for i in covariance_gauge(b16):
        p.set_parameter_block_constant(pts[i])
    s, launches, wall = counted("cov16_solve", lambda: ctt.solve(
        ctt.Options(linear_solver_type=DS), p))
    cost, rows = COV16_GOLDEN["solve"]
    gap = abs(s.final_cost - cost) / cost
    record("cov16_solve", launches, wall, iterations=len(s.iterations) - 1,
           final_cost=s.final_cost, rows=len(s.iterations), gap_to_golden=gap)
    check(str(s.termination_type) == "CONVERGENCE" and len(s.iterations) == rows
          and gap <= 1e-6, f"cov16_solve: {s.termination_type}, {len(s.iterations)} rows, "
          f"{s.final_cost!r}; the JAX package's {rows} rows, {cost!r}")
    var = cams[1:]
    pairs = [(a, b) for a in var for b in var]
    mats = {}
    for name, kw in COV16_PATHS.items():
        cov = ctt.Covariance(ctt.CovarianceOptions(**kw))
        ok, launches, wall = counted(f"cov16_{name}", lambda: cov.compute(pairs, p))
        check(ok, f"cov16_{name}: compute() returned False; the JAX package's True")
        C = np.block([[cov.get_covariance_block(a, b) for b in var] for a in var])
        mats[name] = C
        diag, probes = COV16_GOLDEN["digest"]
        V = np.random.default_rng(0).standard_normal((C.shape[0], len(probes)))
        gaps = (float(np.abs(np.diag(C) - diag).max() / np.abs(C).max()),
                float(np.abs(C @ V - np.asarray(probes).T).max()
                      / np.abs(np.asarray(probes)).max()))
        record(f"cov16_{name}", launches, wall, stats=cov.stats, gaps_to_jax=gaps)
        check(max(gaps) <= COV16_REL, f"cov16_{name}: {gaps} from the JAX package's "
              f"digest (limit {COV16_REL:.0e})")
        check(all(launches[k] > 0 for k in COV_PATH_ROWS[name]),
              f"cov16_{name}: a row of its path launched no time: {launches}")
        check(cov.stats["path"] == name, f"cov16_{name}: took the {cov.stats['path']} path")
    for a in mats:
        for b in mats:
            if a < b:
                gap = float(np.abs(mats[a] - mats[b]).max() / np.abs(mats[b]).max())
                log("slice18 cov16", f"{a} against {b}: {gap:.3e} (limit 1e-06)")
                check(gap <= 1e-6, f"cov16: {a} and {b} {gap:.3e} apart")
    del p, cams, pts, mats
    gc.collect()

    # -- (b) the 400-camera core: the Schur tail on the card ------------------------
    b400 = bal.synthetic_bal_large(**COV400)
    p, cams, _ = anchored_problem(ctt, bal, b400)
    pairs = [(cams[i], cams[i]) for i in range(COV400_BLOCKS)]
    out = {}
    for name, kw, device in (("card", {}, None), ("cpu", {}, "cpu"),
                             ("normal_equations", dict(use_normal_equations=True), None)):
        cov = ctt.Covariance(ctt.CovarianceOptions(**kw))
        ok, launches, wall = counted(f"cov400_{name}",
                                     lambda: cov.compute(pairs, p, device=device),
                                     on_card=device is None)
        check(ok, f"cov400_{name}: compute() returned False")
        out[name] = cov._cov_cols
        record(f"cov400_{name}", launches, wall, stats=cov.stats)
        if name == "card":
            check(cov.stats["path"] == "schur_tail" and all(
                launches[k] > 0 for k in COV_PATH_ROWS["schur_tail"]),
                f"cov400: the card's path {cov.stats['path']}, launches {launches}")
    gaps = {k: float(np.abs(out["card"] - out[k]).max() / np.abs(out[k]).max())
            for k in ("cpu", "normal_equations")}
    paths["cov400_card"]["gaps"] = gaps
    log("slice18 cov400", f"card against CPU {gaps['cpu']:.3e} (limit 1e-09), against the "
        f"normal equations {gaps['normal_equations']:.3e} (limit 1e-06); {card}")
    check(gaps["cpu"] <= 1e-9 and gaps["normal_equations"] <= 1e-6,
          f"cov400: the card's covariance {gaps}")
    del p, cams, out
    gc.collect()

    # -- (c) TinySolver -------------------------------------------------------------
    X, x0, tcams, tobs = triangulations(TINY_LANES)
    resid = triangulation_residual(rot)
    ts = ctt.TinySolver(resid)
    data = (torch.as_tensor(tcams, device=dev), torch.as_tensor(tobs, device=dev))
    x0_d = torch.as_tensor(x0, device=dev)
    (x, s), launches, wall = counted("tiny_batch", lambda: ts.solve_batch(x0_d, data))
    x = x.cpu().numpy()
    loops = ts.last_host_syncs
    near = float(np.mean(np.abs(x - X).max(axis=1) <= 1e-6))
    n = TINY_GOLDEN_LANES
    its = s.iterations[:n].cpu().numpy()
    x_jax = X[:n] + unpack_ints(TINY_GOLDEN["x_minus_truth"], np.int32).reshape(n, 3) \
        * TINY_X_QUANTUM
    cost_ratio = (s.final_cost[:n] / s.initial_cost[:n]).cpu().numpy()
    cost_gap = float(np.abs(cost_ratio - unpack_ints(TINY_GOLDEN["cost_of_initial"], np.int32)
                            * TINY_COST_QUANTUM).max())
    jax_gap = float(np.abs(x[:n] - x_jax).max())
    same_its = bool(np.array_equal(its, unpack_ints(TINY_GOLDEN["iterations"], np.int8)))
    cpu = ctt.TinySolver(resid, device="cpu")
    (xc, sc), _, cpu_wall = counted("tiny_batch_cpu", lambda: cpu.solve_batch(
        x0[:n], (tcams[:n], tobs[:n])), on_card=False)
    cpu_gap = float(np.abs(x[:n] - xc.numpy()).max())
    cpu_its = bool(np.array_equal(its, sc.iterations.numpy()))
    record("tiny_batch", launches, wall, iterations=loops, lanes=TINY_LANES,
           ms_per_iteration=1e3 * wall / max(loops, 1), host_syncs=loops,
           share_within_1e6=near, lanes_within_1e6=int(round(near * TINY_LANES)),
           jax_x_gap=jax_gap, jax_cost_gap_of_initial=cost_gap, jax_same_iterations=same_its,
           cpu_x_gap=cpu_gap, cpu_same_iterations=cpu_its, cpu_wall_s=cpu_wall,
           max_iterations=int(s.iterations.max()))
    check(near >= 0.999, f"tiny_batch: {near:.5f} of the lanes within 1e-6 of their truth")
    check(jax_gap <= 1e-9 and same_its and cost_gap <= 1e-12,
          f"tiny_batch: against the JAX solve_batch x {jax_gap:.3e}, cost {cost_gap:.3e}, "
          f"the same iterations {same_its}")
    check(cpu_gap <= 1e-12 and cpu_its, f"tiny_batch: against the CPU x {cpu_gap:.3e}, "
          f"the same iterations {cpu_its}")
    check(loops == int(s.iterations.max()), f"tiny_batch: {loops} host syncs for "
          f"{int(s.iterations.max())} iterations")
    del x, s, data, x0_d

    def rosen(x, d):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    (xr, sr), launches, wall = counted("tiny_rosenbrock", lambda: ctt.TinySolver(rosen).solve(
        [-1.2, 1.0]))
    xr = xr.cpu().numpy()
    gx, gcost, git = TINY_GOLDEN["rosenbrock"]
    record("tiny_rosenbrock", launches, wall, iterations=int(sr.iterations), x=xr.tolist(),
           final_cost=float(sr.final_cost), jax_x_gap=float(np.abs(xr - gx).max()))
    check(np.abs(xr - 1.0).max() <= 1e-6 and float(sr.final_cost) < 1e-12
          and int(sr.iterations) == git and np.abs(xr - gx).max() <= 1e-9,
          f"tiny_rosenbrock: x {xr}, cost {float(sr.final_cost)}, {int(sr.iterations)} "
          f"iterations; the JAX package's {gx}, {gcost}, {git}")

    # -- (d) the capi and the rotation functions ---------------------------------------
    def capi_run():
        prob = capi.ceres_create_problem()
        x = np.zeros(2)
        rid = capi.ceres_problem_add_residual_block(
            prob, lambda v: v - torch.tensor([1.0, 2.0], dtype=v.dtype, device=v.device), 2,
            [2], [x], loss_function_name="huber", loss_function_parameter=1.0)
        summary = capi.ceres_solve(prob, max_num_iterations=20)
        capi.ceres_free_problem(prob)
        return x, rid, summary, prob.num_residual_blocks()

    (x, rid, s, left), launches, wall = counted("capi", capi_run)
    record("capi", launches, wall, iterations=len(s.iterations) - 1, x=x.tolist(),
           device=s.device_kind)
    check(isinstance(rid, int) and s.is_solution_usable() and np.abs(x - [1.0, 2.0]).max()
          <= 1e-6 and left == 0 and s.device_kind == torch.cuda.get_device_name(0),
          f"capi: x {x}, usable {s.is_solution_usable()}, {left} blocks left, device "
          f"{s.device_kind!r}")
    rng = np.random.default_rng(18)
    aa = rng.standard_normal((ROTATION_BATCH, 3))
    aa[0] = 0.0
    conv = ["IntrinsicZYX", "ExtrinsicXYX"]
    cases = {
        "angle_axis_to_rotation_matrix": (rot.angle_axis_to_rotation_matrix, aa),
        "cross_product_matrix": (rot.cross_product_matrix, aa),
        "euler_angles_to_rotation_matrix": (rot.euler_angles_to_rotation_matrix, 57.0 * aa),
        **{f"euler_angles_to_rotation_{c}": (torch.func.vmap(
            lambda v, c=c: rot.euler_angles_to_rotation(c, v)), aa) for c in conv},
        **{f"rotation_matrix_to_euler_angles_{c}": (torch.func.vmap(
            lambda R, c=c: rot.rotation_matrix_to_euler_angles(c, R)),
            rot.angle_axis_to_rotation_matrix(torch.as_tensor(0.5 * aa)).numpy())
           for c in conv},
    }
    rot_gaps = {}
    for name, (fn, arg) in cases.items():
        on_card = fn(torch.as_tensor(arg, device=dev)).cpu()
        on_cpu = fn(torch.as_tensor(arg))
        rot_gaps[name] = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    log("slice18 rotation", f"{ROTATION_BATCH} inputs, card against CPU, max |diff| / max "
        f"|value|: {json.dumps(rot_gaps)} (limit 1e-12); {card}")
    check(max(rot_gaps.values()) <= 1e-12, f"rotation: card against CPU {rot_gaps}")

    # -- (e) NIST and denoising through the examples -----------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for name in NIST_SHAPES:
            write_nist_file(Path(tmp) / f"{name}.dat", name)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                summaries, launches, wall = counted(f"nist_{name}", lambda: nist_example.main(
                    ["--nist_data_dir", tmp, "--problem", f"{name}.dat", "--device", "cuda"]))
            costs = [s.final_cost for s in summaries]
            gaps = [abs(c - g) / g for c, g in zip(costs, NIST_GOLDEN[name])]
            record(f"nist_{name}", launches, wall,
                   iterations=sum(len(s.iterations) - 1 for s in summaries),
                   rows=[len(s.iterations) for s in summaries], final_costs=costs,
                   gaps_to_jax=gaps, printed=text.getvalue().splitlines()[-1])
            check(len(costs) == len(NIST_GOLDEN[name]) and max(gaps) <= 1e-10
                  and "Total: 2/2" in text.getvalue(),
                  f"nist {name}: final costs {costs}, the JAX package's {NIST_GOLDEN[name]}; "
                  f"{text.getvalue().splitlines()[-1]}")
        write_foe_file(Path(tmp) / "model.foe")
        denoising.write_pgm(Path(tmp) / "noisy.pgm", noisy_image(DENOISE_SIZE))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            s, launches, wall = counted("denoise", lambda: den_example.main(
                ["--input", str(Path(tmp) / "noisy.pgm"), "--foe_file",
                 str(Path(tmp) / "model.foe"), "--output", str(Path(tmp) / "out.pgm"),
                 "--num_iterations", str(DENOISE_ITERATIONS), "--device", "cuda"]))
        out_image = denoising.read_pgm(Path(tmp) / "out.pgm")
    costs = [r.cost for r in s.iterations]
    gaps = [abs(c - g) / abs(g) for c, g in zip(costs, DENOISE_GOLDEN["rows"])]
    n_it = len(s.iterations) - 1
    record("denoise", launches, wall, iterations=n_it, rows=len(costs), gaps_to_jax=gaps,
           cg=[r.linear_solver_iterations for r in s.iterations],
           ms_per_iteration=1e3 * s.minimizer_time_in_seconds / max(n_it, 1),
           preprocessor_s=s.preprocessor_time_in_seconds, host_syncs=s.num_host_syncs,
           final_cost=s.final_cost)
    check(len(costs) == len(DENOISE_GOLDEN["rows"])
          and max(gaps[:DENOISE_ROWS_HELD]) <= 1e-8 and gaps[-1] <= 1e-8,
          f"denoise: {len(costs)} rows, the gaps to the JAX rows {gaps}")
    check(out_image.shape == (DENOISE_SIZE, DENOISE_SIZE), "denoise: the written image")
    check(all(launches[k] > 0 for k in COV_PATH_ROWS["denoise"]),
          f"denoise: a row of the flat CGNR path launched no time: {launches}")
    return time.monotonic() - t_phase


def c120_instance(bal):
    """The 120-camera instance (C120) of the kernel checks, perturbed."""
    return bal.perturb(bal.synthetic_bal(**C120), 0.01, 0.05, 0.05, seed=1)


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] * x[0]) ** 2


def quaternion_fit_cost(q):
    """Rotate the x axis onto the z axis (tests/test_satellite_apis.py:185)."""
    from ceres_tpu_torch import rotation as rot

    one = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=q.device)
    target = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=q.device)
    return torch.sum((rot.unit_quaternion_rotate_point(q, one) - target) ** 2)


def line_search_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu):
    """Port slice 16's paths on the card, each against the JAX package's
    answer (scripts/linesearch16_golden.py, LINESEARCH16_GOLDEN,
    ROSEN16_GOLDEN): (a) BAL-16 and C120 under minimizer_type=LINE_SEARCH,
    LBFGS + WOLFE in the fused loop (AUTO) and the host loop (NEVER),
    nonlinear CG + ARMIJO in the fused loop, to LS16_DEPTH iterations (from
    BAL-16's start every one stops at its first iteration, as the JAX one
    does; C120 makes progress): every row within
    1e-6 of the JAX loop of its kind in float64, 1e-5 in float32, no kernel
    launched (the line search evaluates plainly, as the JAX one does), at
    most one host sync per probe and per iteration and one before the
    first; a float64 repeat on the same Problem, its values put back, bit for
    bit; (b) BAL-16 DENSE_SCHUR with inner iterations, the fused loop in
    float32 for 25 iterations (within 1e-5 of the JAX final cost; rows 1-3
    launched every LM iteration, eval_fused once more for each inner
    sweep) and the host loop in float64 (every row within 1e-6), both
    reporting inner_iterations_used; (c) the sparse phase's pose graphs
    with inner iterations in the host loop (the block colouring), every row
    within 1e-6; (d) Rosenbrock with each direction and search in both
    loops for 300 iterations, the first ROSEN_ROWS rows within 1e-6, LBFGS
    and BFGS at the JAX answer within 1e-9, nonlinear CG + WOLFE with the
    JAX termination, the others below a fifth of the start's cost, and the quaternion fit at the JAX answer within
    1e-9; (f) the card against the CPU: C120 under LBFGS in both loops
    (LS_CARD_VS_CPU_ITERATIONS; each row within 1e-9 or 4x the CPU's
    one-ulp sensitivity) and BAL-16 DENSE_SCHUR with inner
    iterations in both loops (INNER_CARD_VS_CPU_ITERATIONS), each row
    within 1e-9. Part (e), the cache, is cache_check's."""
    from ceres_tpu_torch.models import pose_graph as pg
    from ceres_tpu_torch.solvers.coordinate_descent import CoordinateDescentMinimizer

    LS = ctt.MinimizerType.LINE_SEARCH
    DS = ctt.LinearSolverType.DENSE_SCHUR

    def problem16():
        return bal.build_problem_batched(bal16(bal))

    def summary_fields(s):
        return {k: getattr(s, k) for k in (
            "num_line_search_steps", "num_gradient_evaluations", "num_inner_iteration_steps",
            "inner_iterations_given", "inner_iterations_used",
            "inner_iteration_time_in_seconds", "residual_evaluation_time_in_seconds")}

    def rows_held(path, s, key, limit, extra=""):
        """Each row within `limit` of the JAX loop's."""
        term, cost, rows, _ = LINESEARCH16_GOLDEN[key]
        got = [r.cost for r in s.iterations]
        gaps = [abs(a - b) / (abs(b) or 1.0) for a, b in zip(got, rows)]
        paths[path]["relative_row_gaps_to_jax"] = gaps
        log(f"solve {path}", f"{len(got)} rows, the JAX loop's {len(rows)}; final cost "
            f"{s.final_cost!r}, the JAX loop's {cost!r}; {s.termination_type.name} "
            f"({term}); largest relative row gap {max(gaps):.3e} (limit {limit:.0e}); "
            f"{extra}{card}")
        check(len(got) == len(rows), f"{path}: {len(got)} rows, the JAX loop {len(rows)}")
        check(max(gaps) <= limit, f"{path}: rows off the JAX loop's by {max(gaps):.3e}")
        check(s.termination_type.name == term, f"{path}: {s.termination_type.name}, "
              f"the JAX loop {term}")

    def ls_drive(path, opts, problem):
        """A line-search solve with the counts set to 0 just before it and
        read just after: it launches no kernel and no plain version (the
        line search evaluates plainly, as the JAX one does)."""
        kn.reset_counts()
        s = ctt.solve(opts, problem)
        torch.cuda.synchronize()
        launches, plain_calls = counts(kn)
        n_it = len(s.iterations) - 1
        res = {"iterations": n_it, "summary_rows": len(s.iterations),
               "termination": str(s.termination_type), "message": s.message,
               "initial_cost": s.initial_cost, "final_cost": s.final_cost,
               "host_syncs": s.num_host_syncs,
               "host_syncs_per_iteration": s.num_host_syncs / max(n_it, 1),
               "preprocessor_s": s.preprocessor_time_in_seconds,
               "minimizer_s": s.minimizer_time_in_seconds,
               "ms_per_iteration": 1e3 * s.minimizer_time_in_seconds / max(n_it, 1),
               "probes": s.num_line_search_steps,
               "probes_per_iteration": s.num_line_search_steps / max(n_it, 1),
               "launches": launches, "plain_calls": plain_calls}
        res.update(summary_fields(s))
        log(f"solve {path}", json.dumps(res) + f"; {card}")
        check(not any(launches.values()) and not any(plain_calls.values()),
              f"{path}: a kernel or a plain version ran: {launches} {plain_calls}")
        paths[path] = res
        return s, res

    # -- (a) BAL-16 and C120 under LINE_SEARCH --------------------------------------
    for shape in ("bal16", "c120"):
        for dtn in ("float64", "float32"):
            limit = 1e-6 if dtn == "float64" else 1e-5
            for name, loop, kw in (
                    ("lbfgs", "AUTO", {}), ("lbfgs", "NEVER", {}),
                    ("ncg_armijo", "AUTO", dict(
                        line_search_type=ctt.LineSearchType.ARMIJO,
                        line_search_direction_type=(
                            ctt.LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT)))):
                key = (shape, name, loop, dtn)
                path = f"{shape}_ls_{name}_{'fused' if loop == 'AUTO' else 'host'}_{TAG[dtn]}"
                opts = ctt.Options(minimizer_type=LS, fused_loop=loop, evaluation_dtype=dtn,
                                   max_num_iterations=LS16_DEPTH[dtn], **kw)
                problem, cams, pts = (problem16() if shape == "bal16"
                                      else bal.build_problem_batched(c120_instance(bal)))
                c0, p0 = cams.copy(), pts.copy()
                s, res = ls_drive(path, opts, problem)
                n_it = max(res["iterations"], 1)
                probes, jax_probes = s.num_line_search_steps, LINESEARCH16_GOLDEN[key][3][0]
                rows_held(path, s, key, limit,
                          extra=f"{probes} probes ({jax_probes} in the JAX loop), "
                          f"{s.num_host_syncs} host syncs "
                          f"({res['host_syncs_per_iteration']:.2f} per iteration), "
                          f"{res['ms_per_iteration']:.3f} ms per iteration; ")
                check(s.num_host_syncs <= probes + n_it + 1,
                      f"{path}: {s.num_host_syncs} host syncs for {probes} probes and "
                      f"{n_it} iterations")
                check(probes == jax_probes or dtn == "float32",
                      f"{path}: {probes} probes, the JAX loop {jax_probes}")
                if dtn == "float64":
                    cams[...], pts[...] = c0, p0
                    again = ctt.solve(opts, problem)
                    res["repeat_bit_for_bit"] = ([r.cost for r in again.iterations]
                                                 == [r.cost for r in s.iterations])
                    check(res["repeat_bit_for_bit"], f"{path}: a repeated solve is not bit "
                          f"for bit the first: {again.final_cost!r} against "
                          f"{s.final_cost!r}")

    # -- (b) BAL-16 DENSE_SCHUR with inner iterations --------------------------------
    for loop, dtn in (("ALWAYS", "float32"), ("NEVER", "float64")):
        path = f"bal16_inner_dense_{'fused' if loop == 'ALWAYS' else 'host'}_{TAG[dtn]}"
        opts = ctt.Options(linear_solver_type=DS, use_inner_iterations=True, fused_loop=loop,
                           evaluation_dtype=dtn, max_num_iterations=25)
        s, res = drive(path, opts, problem16()[0],
                       kernels=DENSE_PATH if loop == "ALWAYS" else HOST_PATH)
        n_it = max(res["iterations"], 1)
        res.update(summary_fields(s))
        res["launches_per_iteration"] = {k: v / n_it for k, v in res["launches"].items() if v}
        term, cost, rows, (inner_jax,) = LINESEARCH16_GOLDEN[("inner_dense_schur", loop, dtn)]
        check(s.inner_iterations_used and s.inner_iterations_given,
              f"{path}: inner iterations not reported used")
        check(s.num_inner_iteration_steps >= 1, f"{path}: no inner iteration ran")
        if loop == "ALWAYS":
            gap = (s.final_cost - cost) / cost
            res["gap_to_golden"] = gap
            ev = res["launches"]["eval_fused"]
            # one evaluation per row, one more per LM iteration the inner
            # iterations were on for (at least those whose sweep was taken)
            check(len(s.iterations) + s.num_inner_iteration_steps <= ev
                  <= len(s.iterations) + res["iterations"],
                  f"{path}: eval_fused launched {ev} times for {len(s.iterations)} rows and "
                  f"{s.num_inner_iteration_steps} inner sweeps")
            log(f"solve {path}", f"final cost {s.final_cost!r} in {len(s.iterations)} rows "
                f"(JAX fused loop {cost!r} in {len(rows)}), relative gap {gap:.3e} (limit "
                f"1e-5); {s.num_inner_iteration_steps} inner sweeps taken (the JAX loop "
                f"counts none); launches per LM iteration "
                f"{json.dumps(res['launches_per_iteration'])}; {card}")
            check(abs(gap) <= 1e-5, f"{path}: final cost off the JAX loop's by {gap:.3e}")
        else:
            check(s.num_inner_iteration_steps == inner_jax,
                  f"{path}: {s.num_inner_iteration_steps} inner steps, the JAX loop "
                  f"{inner_jax}")
            rows_held(path, s, ("inner_dense_schur", loop, dtn), 1e-6,
                      f"{s.num_inner_iteration_steps} inner steps in "
                      f"{s.inner_iteration_time_in_seconds:.3f} s, launches per LM iteration "
                      f"{json.dumps(res['launches_per_iteration'])}; ")

    # -- (c) the pose graphs with inner iterations ------------------------------------------
    for name, dims, gen, build in (("pose3d", POSE3D, pg.synthetic_3d, pg.build_problem_3d),
                                   ("pose2d", POSE2D, pg.synthetic_2d, pg.build_problem_2d)):
        n, lc, noise, seed, _ = dims
        path = f"{name}_{n}_inner_f64"
        poses, cons, _ = gen(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
        opts = ctt.Options(use_inner_iterations=True, max_num_iterations=INNER_POSE_DEPTH)
        problem = build(copy.deepcopy(poses), cons)[0]
        s, res = drive(path, opts, problem, kernels=SPARSE_PATH)
        res.update(summary_fields(s))
        sets = len(CoordinateDescentMinimizer(
            next(iter(problem._compiled_cache.values())), opts).sets)
        res["independent_sets"] = sets
        rows_held(path, s, (name, "inner"), 1e-6,
                  f"{sets} independent sets, {s.num_inner_iteration_steps} inner steps in "
                  f"{s.inner_iteration_time_in_seconds:.3f} s, {res['ms_per_iteration']:.1f} ms "
                  f"per LM iteration; ")

    # -- (d) Rosenbrock and the quaternion fit ------------------------------------------------
    t0 = time.monotonic()
    n_runs = 0
    for key, (term, cost, rows, answer) in ROSEN16_GOLDEN.items():
        if key[0] == "quaternion":
            continue
        d, srch, beta, loop = key
        converging = d in ("LBFGS", "BFGS")
        x = np.asarray([-1.2, 1.0])
        s = ctt.solve_gradient_problem(ctt.Options(
            minimizer_type=LS, fused_loop=loop, max_num_iterations=300,
            line_search_direction_type=ctt.LineSearchDirectionType[d],
            line_search_type=ctt.LineSearchType[srch],
            nonlinear_conjugate_gradient_type=ctt.NonlinearConjugateGradientType[beta]),
            ctt.GradientProblem(rosenbrock, 2), x)
        n_runs += 1
        got = [r.cost for r in s.iterations[:ROSEN_ROWS]]
        gaps = [abs(a - b) / (abs(b) or 1.0) for a, b in zip(got, rows)]
        tag = f"rosenbrock {d} {srch} {beta} {loop}"
        check(len(got) == len(rows) and max(gaps) <= 1e-6,
              f"{tag}: first rows off the JAX loop's by {max(gaps):.3e}")
        if converging:
            err = float(np.abs(x - np.asarray(answer)).max())
            check(s.termination_type.name == term and err <= 1e-9,
                  f"{tag}: {s.termination_type.name} at {x.tolist()}, the JAX loop {term} at "
                  f"{answer}")
        elif d == "NONLINEAR_CONJUGATE_GRADIENT" and srch == "WOLFE":
            check(s.termination_type.name == term,
                  f"{tag}: {s.termination_type.name}, the JAX loop {term}")
        else:
            check(s.final_cost < 0.2 * s.iterations[0].cost,
                  f"{tag}: final cost {s.final_cost!r} not below a fifth of the start's")
        log("gradient problem", f"{tag}: {len(s.iterations)} rows, final cost "
            f"{s.final_cost!r} (JAX {cost!r} after 300 iterations at most), "
            f"{s.termination_type.name} ({term}), first "
            f"{ROSEN_ROWS} rows' largest gap {max(gaps):.3e} (limit 1e-6), answer "
            f"{x.tolist()} (JAX {answer}); {s.num_host_syncs} host syncs")
    for loop in ("NEVER", "ALWAYS"):
        term, cost, rows, answer = ROSEN16_GOLDEN[("quaternion", loop)]
        q = np.asarray([1.0, 0.0, 0.0, 0.0])
        s = ctt.solve_gradient_problem(
            ctt.Options(minimizer_type=LS, fused_loop=loop, max_num_iterations=200),
            ctt.GradientProblem(quaternion_fit_cost, 4, manifold=ctt.QuaternionManifold()), q)
        n_runs += 1
        err = float(np.abs(q - np.asarray(answer)).max())
        log("gradient problem", f"quaternion fit {loop}: {len(s.iterations)} rows (JAX "
            f"{len(rows)}), final cost {s.final_cost!r} (JAX {cost!r}), answer {q.tolist()}, "
            f"off the JAX one by {err:.3e} (limit 1e-9)")
        check(s.final_cost < 1e-12 and err <= 1e-9, f"quaternion fit {loop}: answer off the "
              f"JAX one by {err:.3e}, cost {s.final_cost}")
    log("gradient problem", f"{n_runs} solves on the card in {time.monotonic() - t0:.1f} s; "
        f"{card}")

    # -- (f) the card against the CPU ---------------------------------------------------------
    c120 = c120_instance(bal)

    def c120_problem(nudge=False):
        cams = np.nextafter(c120.cameras, np.inf) if nudge else c120.cameras.copy()
        return bal.build_problem_batched(bal.from_arrays(
            cams, c120.points.copy(), c120.camera_index, c120.point_index,
            c120.observations))[0]

    for loop in ("AUTO", "NEVER"):
        # the host loop's interpolation (a least-squares cubic through probes
        # close together) amplifies one-ulp differences: each row within 4x
        # the CPU's own one-ulp sensitivity where that is larger than 1e-9
        card_against_cpu(f"c120_ls_lbfgs_{'fused' if loop == 'AUTO' else 'host'}_card_vs_cpu",
                         ctt.Options(minimizer_type=LS, fused_loop=loop,
                                     max_num_iterations=LS_CARD_VS_CPU_ITERATIONS),
                         c120_problem, lambda: c120_problem(nudge=True), kernels=())
    for loop in ("ALWAYS", "NEVER"):
        card_against_cpu(f"bal16_inner_dense_{'fused' if loop == 'ALWAYS' else 'host'}"
                         "_card_vs_cpu",
                         ctt.Options(linear_solver_type=DS, use_inner_iterations=True,
                                     fused_loop=loop,
                                     max_num_iterations=INNER_CARD_VS_CPU_ITERATIONS),
                         lambda: problem16()[0], None,
                         kernels=DENSE_PATH if loop == "ALWAYS" else HOST_PATH)


def examples_phase(kn, card, paths):
    """Every script of ceres_tpu_torch/examples/ through its main(argv) on
    the card (EXAMPLE_RUNS, with --device cuda), its standard output kept
    out of the log: each solve's final cost within EXAMPLES_REL of the JAX
    script's (EXAMPLES_GOLDEN, scripts/examples_golden.py), the same rows
    and termination; no plain version run on the card; each bundle
    adjustment run (EXAMPLE_PATHS), with the counts set to 0 just before
    it and read just after, launched each kernel of its path; the
    full_report of FULL_REPORT_RUN printed, its Device line the card's.
    Every run is made before a failure of the gates is raised. Returns the
    phase's seconds."""
    import contextlib
    import importlib
    import io
    import tempfile
    from pathlib import Path

    t0 = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        libmv_file = str(Path(tmp) / "libmv16.bin")
        write_libmv_file(libmv_file, libmv16())
        for key in EXAMPLE_RUNS:
            name, *argv = key.split()
            argv = [libmv_file if a == LIBMV16_FILE else a for a in argv]
            mod = importlib.import_module(f"ceres_tpu_torch.examples.{name}")
            out, stdin = io.StringIO(), sys.stdin
            kn.reset_counts()
            t1 = time.monotonic()
            try:
                sys.stdin = io.StringIO("")
                with contextlib.redirect_stdout(out):
                    ret = mod.main(argv + ["--device", "cuda"])
            finally:
                sys.stdin = stdin
            torch.cuda.synchronize()
            wall = time.monotonic() - t1
            launches, plain_calls = counts(kn)
            summaries = ret if isinstance(ret, list) else [ret]
            golden = EXAMPLES_GOLDEN[key]
            check(len(summaries) == len(golden),
                  f"{key}: {len(summaries)} solves, the JAX script {len(golden)}")
            gaps = []
            for s, (term, cost, rows, initial) in zip(summaries, golden):
                floor = EXAMPLES_ABS_OF_INITIAL * abs(initial)
                gap = abs(s.final_cost - cost)
                tol = floor if abs(cost) < floor else EXAMPLES_REL * abs(cost)
                gaps.append(gap if abs(cost) < floor else gap / abs(cost))
                if (str(s.termination_type) != term or len(s.iterations) != rows
                        or gap > tol):
                    failures.append(
                        f"{key}: {s.termination_type}, {len(s.iterations)} rows, final cost "
                        f"{s.final_cost!r}; the JAX script {term}, {rows}, {cost!r}")
                if s.device_kind not in ("", kind):
                    failures.append(f"{key}: device {s.device_kind!r}")
            if any(plain_calls.values()):
                failures.append(f"{key}: a plain version ran on the card: {plain_calls}")
            res = {"solves": len(summaries), "rows": [len(s.iterations) for s in summaries],
                   "gaps": gaps, "wall_s": wall,
                   "minimizer_s": sum(s.minimizer_time_in_seconds for s in summaries),
                   "host_syncs": sum(s.num_host_syncs for s in summaries),
                   "stdout_lines": len(out.getvalue().splitlines())}
            if key in EXAMPLE_PATHS:
                path, kernels = EXAMPLE_PATHS[key]
                s = summaries[0]
                res.update({"iterations": len(s.iterations) - 1, "launches": launches,
                            "ms_per_iteration": 1e3 * s.minimizer_time_in_seconds
                            / max(len(s.iterations) - 1, 1)})
                if not all(launches[k] > 0 for k in kernels):
                    failures.append(f"{key}: a kernel of its path launched no time: "
                                    f"{launches}")
                paths[path] = res
            log(f"example {key}", json.dumps(res) + f"; {card}")
            if key == FULL_REPORT_RUN:
                report = summaries[0].full_report()
                check(f"Device                    {kind} x1" in report.splitlines(),
                      f"{key}: the report's Device line does not name the card")
                for line in report.splitlines():
                    log("full_report", line)
    check(not failures, "the examples: " + "; ".join(failures))
    return time.monotonic() - t0


def cache_check(ctt, path, opts, build, card):
    """(e) The compiled-program cache: solve a Problem, put its values back
    in place, solve it again, and solve a fresh Problem of the same
    values. The repeat takes the same program and (in the fused loop) the
    same fused minimizer objects, and all three solves' rows are equal bit
    for bit. Logs the time to the first iteration (the preprocessor's) of
    the first solve and of the repeat, and the set-up outside the solves:
    building the Problem from the arrays."""
    t0 = time.monotonic()
    problem, *arrays = build()
    build_s = time.monotonic() - t0
    saved = [a.copy() for a in arrays]
    s1 = ctt.solve(opts, problem)
    torch.cuda.synchronize()
    (prog,) = problem._compiled_cache.values()
    fused = dict(prog._minimizer_cache)
    for a, v in zip(arrays, saved):
        a[...] = v
    s2 = ctt.solve(opts, problem)
    torch.cuda.synchronize()
    same_program = next(iter(problem._compiled_cache.values())) is prog
    same_minimizer = (prog._minimizer_cache == fused and bool(fused)
                      == (opts.fused_loop != "NEVER"))
    del problem, prog, fused, arrays
    gc.collect()
    torch.cuda.empty_cache()
    s3 = ctt.solve(opts, build()[0])
    torch.cuda.synchronize()
    rows = [[(r.cost, r.gradient_max_norm) for r in s.iterations] for s in (s1, s2, s3)]
    res = {"rows": len(rows[0]), "same_program": same_program,
           "same_fused_minimizer": same_minimizer,
           "repeat_equals_first_and_fresh": rows[0] == rows[1] == rows[2],
           "time_to_first_iteration_first_s": s1.preprocessor_time_in_seconds,
           "time_to_first_iteration_repeat_s": s2.preprocessor_time_in_seconds,
           "time_to_first_iteration_fresh_s": s3.preprocessor_time_in_seconds,
           "minimizer_s": [s.minimizer_time_in_seconds for s in (s1, s2, s3)],
           "problem_build_s": build_s}
    log(f"cache {path}", json.dumps(res) + f"; {card}")
    check(same_program and same_minimizer, f"{path}: the repeat built a new program or "
          f"fused minimizer")
    check(res["repeat_equals_first_and_fresh"], f"{path}: the repeated solve's rows differ "
          f"from the first's or a fresh one's")
    return res


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
        prog = CompiledProgram(bal.build_problem_batched(bal16(bal))[0], dtn, device=dev)
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
                       bal.build_problem_batched(bal16(bal))[0], kernels=CGNR_PATH)
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
    same = reused(lambda: bal.build_problem_batched(bal16(bal))[0])
    paths["bal16_cgnr_f64"]["profile"] = profile_solve(
        lambda: ctt.solve(ctt.Options(linear_solver_type=CGNR), same()),
        anchor=SEGMENT_SUM_ANCHOR)
    log("profile bal16_cgnr_f64", json.dumps(paths["bal16_cgnr_f64"]["profile"])
        + f"; {card}")
    log_row_passes("bal16_cgnr_f64", paths["bal16_cgnr_f64"]["profile"], card)
    ulp16b = bal16(bal)
    ulp16b.cameras[...] = np.nextafter(ulp16b.cameras, np.inf)
    card_against_cpu(
        "bal16_cgnr_card_vs_cpu",
        ctt.Options(linear_solver_type=CGNR,
                    max_num_iterations=CGNR16_CARD_VS_CPU_ITERATIONS),
        lambda: bal.build_problem_batched(bal16(bal))[0],
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
        s, res = drive(path, opts, bal.build_problem_batched(bal16(bal))[0],
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
        same = reused(lambda: bal.build_problem_batched(bal16(bal))[0])
        res["profile"] = profile_solve(lambda: ctt.solve(opts, same()),
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
        return bal.build_problem_batched(bal16(bal))[0]

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
            same = reused(problem16)
            res["profile"] = profile_solve(lambda: ctt.solve(opts, same()),
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
        b = bal16(bal)
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
        same = reused(problem16)
        res["profile"] = profile_solve(lambda: dogleg_solver(dogleg_opts(dogleg), same()),
                                       anchor=SEGMENT_SUM_ANCHOR, repeats=3)
        log(f"profile {path}", json.dumps(res["profile"]) + f"; {card}")

    # -- (4) MGH under the default fused_loop: the host loop ------------------------------
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        mgh_card_vs_cpu(ctt, kn, dev, card, paths, "mgh_host_" + lst.lower(),
                        {"linear_solver_type": ctt.LinearSolverType[lst]}, MGH_MISSES)

    # -- (5) the card against the CPU -------------------------------------------------------
    ulp16 = bal16(bal)
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


def subset_ids(problem, b):
    """The residual blocks of a per-block BAL problem but one observation of
    each point seen at least SUBSET_DROP_MIN times."""
    counts_ = np.bincount(np.asarray(b.point_index), minlength=b.num_points)
    dropped, keep = set(), []
    for rb, p in zip(problem.residual_blocks(), np.asarray(b.point_index)):
        if counts_[p] >= SUBSET_DROP_MIN and p not in dropped:
            dropped.add(p)
            continue
        keep.append(rb.rb_id)
    return keep


def sparse_kernel_inputs(ctt, bal, prog):
    """The kernel cases of the sparse steps at BAL-16's first step (Jacobi
    scales, an LM diagonal at radius 1e4): SPARSE_SCHUR's largest group of
    block-pair products (81 wide) with its plan of chunks, the gather of the
    pairs' W rows (27) and of the summed blocks to their CSR positions (1);
    SPARSE_NORMAL_CHOLESKY's camera-camera products of J'J (81; the group of
    the most rows a block, ~5,000 over BAL-16's 256 camera pairs). S is formed
    in float64 at either evaluation dtype, J'J in the evaluation dtype."""
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.solvers.bsr_kernels import BlockTrustRegionKernels
    from ceres_tpu_torch.solvers.linear.implicit_schur import build_schur_system
    from ceres_tpu_torch.utils import ordering

    k = BlockTrustRegionKernels(prog, ctt.Options(), "SPARSE_SCHUR",
                                e_families=ordering.eligible_e_sets(prog))
    _, r, _, J, _, _ = k.eval_full(prog.initial_state())
    scale = k.jacobi_scale(J)
    D = torch.sqrt(k.lm_diagonal(J, scale) / 1e4).double()
    vs = tuple(tuple(V.double() for V in jacs) for jacs in k.flat.scale_columns(J.vflat, scale))
    sss = k.sparse
    sys_ = build_schur_system(k.pm, vs, r.double(), pt.extract_e(k.pm, D), k.flat)
    products = sss.pairs.products(vs, sys_.minv)
    plan = sss.plan
    g = max(plan.groups, key=lambda g: g.order.numel())
    corr = next(m for m in g.members if m[0] == "corr")
    flat = torch.cat([plan.group_sums(h, products).reshape(-1) for h in plan.groups])
    snc = BlockTrustRegionKernels(prog, ctt.Options(), "SPARSE_NORMAL_CHOLESKY")
    vs_j = snc.flat.scale_columns(J.vflat, scale)
    ipc = snc.sparse.ipc
    gj = max(ipc.plan.groups, key=lambda h: h.order.numel() / len(h.pairs))
    kinds = prog.kinds
    from ceres_tpu_torch.ops.inner_product import row_products
    return {
        "segment_block_sum_schur": (plan.group_products(g, products),
                                    g.seg if g.chunk is None else g.chunk),
        "segment_block_expand_schur": (sss.pairs._rows(vs, sys_.minv)[corr[1]][0], corr[3]),
        "segment_block_expand_csr": (flat[:, None].contiguous(), plan.src),
        "segment_block_sum_jtj": (ipc.plan.group_products(
            gj, lambda m, ta, tb: row_products(kinds, vs_j, m, ta, tb)), gj.seg),
    }


def sparse_phase(ctt, bal, libmv, kn, dev, card, paths, drive, card_against_cpu,
                 check_and_time, lp16, ulp16):
    """Port slice 14's paths, the sparse direct solvers in the host loop on
    the card, each against the JAX host loop's answer
    (scripts/sparse16_golden.py, SPARSE16_GOLDEN): rows 6 and 7 held
    against their plain versions at BAL-16 SPARSE_SCHUR's and
    SPARSE_NORMAL_CHOLESKY's first step (sparse_kernel_inputs); BAL-16
    SPARSE_SCHUR in float64 (within 1e-6, the same rows) and float32
    (1e-5); SPARSE_NORMAL_CHOLESKY with the default options, dynamic
    sparsity and mixed-precision solves (1e-6, the same rows); BAL-16
    built per block with CGNR + SUBSET (1e-6; its CG counts logged beside
    the JAX package's); the pose graphs of 2,500 poses (3D) and 3,500 (2D)
    with the default options (1e-6, the same rows); libmv16 SPARSE_SCHUR
    and the 2,048-camera instance with SPARSE_SCHUR for 3 LM iterations on
    the card against the CPU. Each run logs ms per LM iteration, the host's
    ms in factorizations and solves, the MB brought from the device per LM
    iteration, the host syncs, the Cholesky tier, and each float64 run a
    repeat bit for bit; at least one run takes the supernodal tier."""
    from ceres_tpu_torch import native
    from ceres_tpu_torch.models import pose_graph as pg
    from ceres_tpu_torch.program import CompiledProgram

    LS = ctt.LinearSolverType
    SS, SNC = LS.SPARSE_SCHUR, LS.SPARSE_NORMAL_CHOLESKY
    for dtn in ("float64", "float32"):
        prog = CompiledProgram(bal.build_problem_batched(bal16(bal))[0], dtn, device=dev)
        check_and_time("bal16_sparse", dtn, sparse_kernel_inputs(ctt, bal, prog), 100, 10)
        del prog
    tiers = {}

    def sparse_drive(path, opts, problem_fn, kernels=SPARSE_PATH, repeat=True):
        """drive() with the native counts, the JAX gate and, in float64 with
        `repeat`, a repeat bit for bit."""
        native.reset_stats()
        s, res = drive(path, opts, problem_fn(), kernels=kernels)
        st = dict(native.STATS)
        n_it = max(res["iterations"], 1)
        res.update(host_factor_ms_per_iteration=1e3 * st["factor_s"] / n_it,
                   host_solve_ms_per_iteration=1e3 * st["solve_s"] / n_it,
                   dtoh_mb_per_iteration=st["dtoh_bytes"] / 2**20 / n_it,
                   factorizations=st["factorizations"], host_solves=st["solves"],
                   cholesky_tier={t: st[t] for t in ("supernodal", "simplicial")})
        for t in ("supernodal", "simplicial"):
            tiers[t] = tiers.get(t, 0) + st[t]
        dtn = opts.evaluation_dtype
        cost, rows = SPARSE16_GOLDEN[path]
        gap = (s.final_cost - cost) / cost
        res["gap_to_golden"] = gap
        limit = 1e-6 if dtn == "float64" else 1e-5
        check(s.is_solution_usable(), f"{path}: solution not usable: {s.message}")
        check(abs(gap) <= limit, f"{path}: final cost off the JAX host loop's by {gap:.3e}")
        if dtn == "float64":
            check(len(s.iterations) == rows,
                  f"{path}: {len(s.iterations)} rows, the JAX host loop {rows}")
        text = (f"final cost {s.final_cost!r} in {len(s.iterations)} rows (JAX host loop "
                f"{cost!r} in {rows}), relative gap {gap:.3e} (limit {limit:.0e}); ")
        if dtn == "float64" and repeat:
            again = ctt.solve(opts, problem_fn())
            res["repeat_bit_for_bit"] = ([r.cost for r in again.iterations]
                                         == [r.cost for r in s.iterations])
            check(res["repeat_bit_for_bit"], f"{path}: a repeated solve is not bit for bit "
                  f"the first: {again.final_cost!r} against {s.final_cost!r}")
        log(f"solve {path}", text + f"{res['ms_per_iteration']:.3f} ms per LM iteration, "
            f"host factorizations {res['host_factor_ms_per_iteration']:.3f} ms and solves "
            f"{res['host_solve_ms_per_iteration']:.3f} ms per LM iteration "
            f"({st['factorizations']} factorizations, tiers {res['cholesky_tier']}), "
            f"{res['dtoh_mb_per_iteration']:.3f} MB from the device per LM iteration, "
            f"{res['host_syncs_per_iteration']:.2f} host syncs per LM iteration, repeat bit "
            f"for bit {res.get('repeat_bit_for_bit', 'not run')}; {card}")
        return s, res

    def problem16():
        return bal.build_problem_batched(bal16(bal))[0]

    # -- BAL-16: SPARSE_SCHUR and SPARSE_NORMAL_CHOLESKY ---------------------------
    for dtn in ("float64", "float32"):
        sparse_drive("bal16_sparse_schur_" + TAG[dtn],
                     ctt.Options(linear_solver_type=SS, evaluation_dtype=dtn), problem16)
    sparse_drive("bal16_snc_f64", ctt.Options(), problem16)
    sparse_drive("bal16_snc_dynamic_f64",
                 ctt.Options(linear_solver_type=SNC, dynamic_sparsity=True, fused_loop="NEVER",
                             max_num_iterations=DYNAMIC16_ITERATIONS), problem16, repeat=False)
    sparse_drive("bal16_snc_mixed_f64",
                 ctt.Options(linear_solver_type=SNC, use_mixed_precision_solves=True,
                             max_num_refinement_iterations=3, fused_loop="NEVER",
                             max_num_iterations=25), problem16)

    # -- BAL-16 built per block: CGNR + SUBSET -------------------------------------
    b16 = bal16(bal)
    keep = subset_ids(bal.build_problem(bal16(bal))[0], b16)
    opts = ctt.Options(linear_solver_type=LS.CGNR,
                       preconditioner_type=ctt.PreconditionerType.SUBSET,
                       residual_blocks_for_subset_preconditioner=keep, eta=1e-2,
                       max_num_iterations=35, fused_loop="NEVER")
    s, res = sparse_drive("bal16_cgnr_subset_f64", opts,
                          lambda: bal.build_problem(bal16(bal))[0],
                          kernels=("normal_matvec",) + SPARSE_PATH)
    check(s.preconditioner_type_used == ctt.PreconditionerType.SUBSET,
          f"bal16_cgnr_subset_f64: preconditioner used {s.preconditioner_type_used}")
    log("cg bal16_cgnr_subset_f64", f"{len(keep)} of {b16.num_observations} residual "
        f"blocks in the subset; CG iterations per row {res['linear_solver_iterations']}, "
        f"the JAX package's {JAX_SUBSET16_CG} (a record: CG counts follow rounding)")

    # -- the pose graphs ----------------------------------------------------------------
    for path, dims in (("pose3d_2500_snc_f64", POSE3D), ("pose2d_3500_snc_f64", POSE2D)):
        n, lc, noise, seed, its = dims
        t0 = time.monotonic()
        gen = pg.synthetic_3d if path.startswith("pose3d") else pg.synthetic_2d
        build = pg.build_problem_3d if path.startswith("pose3d") else pg.build_problem_2d
        poses, cons, _ = gen(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
        log(path, f"{n} poses, {len(cons)} edges, generated in "
            f"{time.monotonic() - t0:.2f} s on the host")
        s, res = sparse_drive(path, ctt.Options(max_num_iterations=its),
                              lambda: build(copy.deepcopy(poses), cons)[0])
        check(s.linear_solver_type_used == SNC, f"{path}: {s.linear_solver_type_used}")

    check(tiers.get("supernodal", 0) > 0 and tiers.get("simplicial", 0) > 0,
          f"the sparse runs took the Cholesky tiers {tiers}: not both")

    # -- libmv16 and 2,048 cameras: SPARSE_SCHUR on the card against the CPU -------
    native.reset_stats()
    card_against_cpu("libmv16_sparse_schur_card_vs_cpu",
                     ctt.Options(linear_solver_type=SS,
                                 max_num_iterations=LIBMV16_SPARSE_CARD_VS_CPU_ITERATIONS),
                     lambda: libmv.build_problem(fresh(lp16))[0],
                     lambda: libmv.build_problem(fresh(ulp16))[0], kernels=SPARSE_PATH)
    small = bal.perturb(bal.synthetic_bal_large(**SMALL_VENICE), **VENICE_PERTURB)
    ulp = bal.from_arrays(np.nextafter(small.cameras, np.inf), small.points,
                          small.camera_index, small.point_index, small.observations)

    def small_problem(b=small):
        return bal.build_problem_batched(bal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    native.reset_stats()
    card_against_cpu("c2048_sparse_schur_f64",
                     ctt.Options(linear_solver_type=SS,
                                 max_num_iterations=SPARSE_C2048_LM_ITERATIONS),
                     small_problem, lambda: small_problem(ulp), kernels=SPARSE_PATH)
    st = dict(native.STATS)
    log("solve c2048_sparse_schur_f64", f"host factorizations {1e3 * st['factor_s']:.1f} ms "
        f"and solves {1e3 * st['solve_s']:.1f} ms over the card's and both CPU solves "
        f"({st['factorizations']} factorizations; tiers supernodal {st['supernodal']}, "
        f"simplicial {st['simplicial']}); {card}")


def precond_options(ctt, path, loop, dtn, **kw):
    """ITERATIVE_SCHUR with a PRECOND_PATHS path's options."""
    o = dict(PRECOND_PATHS[path], **kw)
    for name, enum in (("preconditioner_type", ctt.PreconditionerType),
                       ("visibility_clustering_type", ctt.VisibilityClusteringType)):
        if name in o:
            o[name] = enum[o[name]]
    return ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                       evaluation_dtype=dtn, fused_loop=loop, **o)


def precond_kernel_inputs(ctt, prog, opts_cluster):
    """The kernel cases of the new paths at a program's first step (Jacobi
    scales, an LM diagonal at radius 1e4), in float64 as the paths form
    them: the cluster assembly's largest group of block-pair products (row
    6) and the gather of the pair sums into the (C, m, m) layout (row 7),
    under `opts_cluster`; the explicit S's product, z gathered by column
    (row 7, 1 wide) and the products summed by row (row 6, 1 wide)."""
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.solvers.bsr_kernels import BlockTrustRegionKernels
    from ceres_tpu_torch.solvers.linear.implicit_schur import build_schur_system
    from ceres_tpu_torch.utils import ordering

    e_fams = ordering.eligible_e_sets(prog)
    k = BlockTrustRegionKernels(prog, opts_cluster, "ITERATIVE_SCHUR", e_families=e_fams)
    _, r, _, J, _, _ = k.eval_full(prog.initial_state())
    scale = k.jacobi_scale(J)
    D = torch.sqrt(k.lm_diagonal(J, scale) / 1e4).double()
    vs = tuple(tuple(V.double() for V in jacs) for jacs in k.flat.scale_columns(J.vflat, scale))
    asm, fl, pm = k.cluster_assembler, k.flat, k.pm
    minv = fl.inverse_flats(pm.e_fams, fl.block_ete(vs), pt.extract_e(pm, D))
    products = asm.pairs.products(vs, minv)
    g = max(asm.plan.groups, key=lambda g: g.order.numel())
    sums = asm.plan.sums(products)
    sums = torch.cat([sums, sums.new_zeros((1,))])[:, None].contiguous()
    args = {"segment_block_sum_cluster": (asm.plan.group_products(g, products),
                                          g.seg if g.chunk is None else g.chunk),
            "segment_block_expand_cluster": (sums, asm.src_d)}
    kx = BlockTrustRegionKernels(prog, ctt.Options(
        linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
        use_explicit_schur_complement=True), "ITERATIVE_SCHUR", e_families=e_fams)
    sys_ = build_schur_system(pm, vs, r.double(), pt.extract_e(pm, D), kx.flat)
    svals = kx.sparse.values(vs, sys_.minv, pt.extract_f(pm, D))
    mv = kx.matvec
    zc = sys_.rhs[mv.cols.long()]
    args["segment_block_expand_csr_matvec"] = (sys_.rhs[:, None].contiguous(), mv.cols)
    args["segment_block_sum_csr_matvec"] = ((svals * zc)[:, None].contiguous(), mv.rows)
    return args


def precond_phase(ctt, bal, kn, dev, card, paths, drive, card_against_cpu,
                  check_and_time):
    """Port slice 15's paths: ITERATIVE_SCHUR with SCHUR_POWER_SERIES_EXPANSION,
    SCHUR_JACOBI with the power series' initial guess, CLUSTER_JACOBI under
    CANONICAL_VIEWS and SINGLE_LINKAGE, CLUSTER_TRIDIAGONAL and the explicit
    S. Rows 6 and 7 held against their plain versions and timed at the
    cluster assembly's and the CSR product's inputs (BAL-16); the
    clustering's host seconds, cluster count and largest cluster, as each
    cluster run made it; BAL-16 uncut on each path in the fused loop
    and the host loop, float64 within 1e-6 of the JAX package's answer
    (scripts/precond16_golden.py, PRECOND16_GOLDEN) in its rows and a
    repeat bit for bit, float32 within 1e-5; at 2,048 cameras
    CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL (fused loop) and the host loop's
    explicit S on the card against the CPU (PRECOND_CARD_VS_CPU_LM_ITERATIONS),
    the fused explicit S on the card alone
    (PRECOND_LARGE_LM_ITERATIONS; its CPU half would hold a dense A of
    13 GB): costs finite and falling, a repeat bit for bit, peak memory. Each run logs ms per LM iteration, CG
    iterations and host syncs."""
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.linear import preconditioners as tpc

    small = bal.perturb(bal.synthetic_bal_large(**SMALL_VENICE), **VENICE_PERTURB)

    def small_problem(b=small):
        return bal.build_problem_batched(bal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    def log_clustering(path):
        """The clustering the run `path` made (preconditioners.STATS)."""
        st = dict(tpc.STATS)
        paths[path]["clustering"] = st
        log(f"clustering {path}", f"{st['clusters']} clusters, the largest m = "
            f"{st['largest_m']} columns, {st['chains']} chains over {st['forest_edges']} "
            f"forest edges; the visibility graph, clustering and forest took "
            f"{st['host_seconds']:.3f} s on the host")

    # -- the kernels at the new paths' inputs ------------------------------------------
    # (the cluster blocks and S are float64 at either evaluation dtype: one
    # check each)
    prog = CompiledProgram(bal.build_problem_batched(bal16(bal))[0], device=dev)
    args = precond_kernel_inputs(ctt, prog, precond_options(
        ctt, "ct", "NEVER", "float64", visibility_clustering_type="SINGLE_LINKAGE"))
    check_and_time("bal16_precond", "float64", args, 100, 10)
    del prog, args
    gc.collect()
    torch.cuda.empty_cache()

    # -- BAL-16, every path in both loops and both dtypes ----------------------------
    def problem16():
        return bal.build_problem_batched(bal16(bal))[0]

    for path in PRECOND_PATHS:
        for loop in ("ALWAYS", "NEVER"):
            for dtn in ("float64", "float32"):
                opts = precond_options(ctt, path, loop, dtn)
                name = f"bal16_{path}_{'fused' if loop == 'ALWAYS' else 'host'}_{TAG[dtn]}"
                kernels = (FLAT_DENSE_PATH if path == "explicit" and loop == "ALWAYS"
                           else FLAT_ITERATIVE_PATH)
                tpc.STATS.clear()
                s, res = drive(name, opts, problem16(), kernels=kernels)
                if tpc.STATS and dtn == "float64" and loop == "ALWAYS":
                    log_clustering(name)
                cost, rows = PRECOND16_GOLDEN[(path, loop, dtn)]
                gap = (s.final_cost - cost) / cost
                res["gap_to_golden"] = gap
                limit = 1e-6 if dtn == "float64" else 1e-5
                check(s.is_solution_usable(), f"{name}: solution not usable: {s.message}")
                check(abs(gap) <= limit, f"{name}: final cost off the JAX package's by "
                      f"{gap:.3e}")
                if dtn == "float64":
                    check(len(s.iterations) == rows,
                          f"{name}: {len(s.iterations)} rows, the JAX package's {rows}")
                    again = ctt.solve(opts, problem16())
                    res["repeat_bit_for_bit"] = ([r.cost for r in again.iterations]
                                                 == [r.cost for r in s.iterations])
                    check(res["repeat_bit_for_bit"], f"{name}: a repeated solve is not "
                          f"bit for bit the first: {again.final_cost!r} against "
                          f"{s.final_cost!r}")
                log(f"solve {name}", f"final cost {s.final_cost!r} in {len(s.iterations)} "
                    f"rows (JAX {cost!r} in {rows}), relative gap {gap:.3e} (limit "
                    f"{limit:.0e}); {res['ms_per_iteration']:.3f} ms per LM iteration, "
                    f"CG iterations {res['linear_solver_iterations']}, "
                    f"{res['host_syncs_per_iteration']:.2f} host syncs per LM iteration, "
                    f"repeat bit for bit {res.get('repeat_bit_for_bit', 'not run')}; {card}")

    # -- 2,048 cameras ---------------------------------------------------------------
    # card against CPU without the one-ulp CPU solve (each row within 1e-9,
    # the same CG counts): the CPU solves take most of the phase
    for path in ("cj_cv", "ct"):
        tpc.STATS.clear()
        card_against_cpu(f"c2048_{path}_f64", precond_options(
            ctt, path, "AUTO", "float64",
            max_num_iterations=PRECOND_CARD_VS_CPU_LM_ITERATIONS[path]),
            small_problem, None, kernels=FLAT_ITERATIVE_PATH)
        log_clustering(f"c2048_{path}_f64")  # the CPU solve's, the same clustering
        gc.collect()
        torch.cuda.empty_cache()
    card_against_cpu("c2048_explicit_host_f64", precond_options(
        ctt, "explicit", "NEVER", "float64",
        max_num_iterations=PRECOND_CARD_VS_CPU_LM_ITERATIONS["explicit"]),
        small_problem, None, kernels=FLAT_ITERATIVE_PATH)
    gc.collect()
    torch.cuda.empty_cache()
    path = "c2048_explicit_fused_f64"
    opts = precond_options(ctt, "explicit", "ALWAYS", "float64",
                           max_num_iterations=PRECOND_LARGE_LM_ITERATIONS)
    s, res = drive(path, opts, small_problem(), kernels=FLAT_DENSE_PATH)
    finite_falling_repeat(ctt, path, s, res, opts, small_problem, card)


def finite_falling_repeat(ctt, path, s, res, opts, problem_fn, card):
    """The gates of a run with no CPU half: every cost finite, falling over
    successful steps, and a repeat bit for bit; logs the run's times and
    its peak device memory."""
    costs = [r.cost for r in s.iterations]
    check(all(np.isfinite(c) for c in costs), f"{path}: a cost is not finite")
    accepted = [s.iterations[0].cost] + [
        r.cost for r in s.iterations[1:] if r.step_is_successful]
    check(len(accepted) >= 2 and all(b < a for a, b in zip(accepted, accepted[1:])),
          f"{path}: the cost did not decrease over successful steps: {accepted}")
    gc.collect()
    torch.cuda.empty_cache()
    again = ctt.solve(opts, problem_fn())
    torch.cuda.synchronize()
    res["repeat_bit_for_bit"] = [r.cost for r in again.iterations] == costs
    res["repeat_ms_per_iteration"] = (1e3 * again.minimizer_time_in_seconds
                                      / max(res["iterations"], 1))
    check(res["repeat_bit_for_bit"], f"{path}: a repeated solve differs")
    log(f"solve {path}", f"costs {costs}; {res['ms_per_iteration']:.3f} ms per LM "
        f"iteration ({res['repeat_ms_per_iteration']:.3f} in the repeat), CG iterations "
        f"{res['linear_solver_iterations']}, {res['host_syncs_per_iteration']:.2f} host "
        f"syncs per LM iteration, peak device memory "
        f"{res['peak_device_bytes'] / 2**30:.3f} GiB, repeat bit for bit; {card}")
    del again
    gc.collect()
    torch.cuda.empty_cache()


def precond_venice(ctt, card, drive, problem_fn):
    """The precond phase's Venice run: float32 ITERATIVE_SCHUR with
    SCHUR_POWER_SERIES_EXPANSION for PRECOND_LARGE_LM_ITERATIONS LM
    iterations (the fused loop, on the flat path): costs finite and
    falling, a repeat bit for bit."""
    path = "venice_spse_f32"
    opts = precond_options(ctt, "spse", "AUTO", "float32",
                           max_num_iterations=PRECOND_LARGE_LM_ITERATIONS)
    s, res = drive(path, opts, problem_fn(), kernels=FLAT_ITERATIVE_PATH)
    finite_falling_repeat(ctt, path, s, res, opts, problem_fn, card)


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
    same = reused(problem_fn)
    paths[path]["profile"] = profile_solve(lambda: ctt.solve(opts, same()),
                                           anchor=SEGMENT_SUM_ANCHOR, repeats=1)
    log(f"profile {path}", json.dumps(paths[path]["profile"]) + f"; {card}")


def mgh_card_vs_cpu(ctt, kn, dev, card, paths, path, over, misses_want):
    """MGH 1-19 under `over` on the card and on the CPU: the misses
    `misses_want`, the same verdicts, each 2 x final cost within 1e-8 of
    the CPU's (both under 1e-20 at a zero optimum; #16, whose crawl
    amplifies rounding tenfold every five rows (tests/test_torch_mgh.py):
    run to MGH16_CARD_VS_CPU_ITERATIONS, its first 40 rows to 1e-9 and its
    end within 5%), no kernel launched."""
    from ceres_tpu_torch.models import mgh

    lst = over["linear_solver_type"].name
    kn.reset_counts()
    t0 = time.monotonic()
    def over_of(p):
        return (dict(over, max_num_iterations=MGH16_CARD_VS_CPU_ITERATIONS)
                if p.number == 16 else over)

    card_runs = {p.number: mgh.solve_problem(p, options_overrides=over_of(p), device=dev)
                 for p in mgh.PROBLEMS}
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    launches, plain_calls = counts(kn)
    t0 = time.monotonic()
    cpu_runs = {p.number: mgh.solve_problem(p, options_overrides=over_of(p), device="cpu")
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
                       bal.build_problem_batched(bal16(bal))[0], extra_evaluations=1)
        res["phases"] = re.findall(r"\((\d+) its\)", s.message)
        gate(path, s, "float64", f"; {s.message[:60]}")

    # -- (d) mixed-precision solves: the flat dense-Schur step ------------------------
    path = "bal16_mixed_solves_dense_f64"
    s, _ = drive(path, ctt.Options(linear_solver_type=DS, use_mixed_precision_solves=True),
                 bal.build_problem_batched(bal16(bal))[0], flat=True)
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
    p = bal.build_problem_batched(bal16(bal))[0]
    arrays = p.parameter_block_arrays()
    s, _ = drive(path, ctt.Options(linear_solver_type=DS,
                                   linear_solver_ordering=[[arrays[1]], [arrays[0]]]), p)
    default = ctt.solve(ctt.Options(linear_solver_type=DS),
                        bal.build_problem_batched(bal16(bal))[0])
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


def mesh_digest(cams, pts):
    """scripts/sharded16_golden.py's digest of a state: each table's
    column sums of squares, the first two cameras, eight points spread
    over the table."""
    cams, pts = np.asarray(cams, np.float64), np.asarray(pts, np.float64)
    idx = np.linspace(0, pts.shape[0] - 1, 8).astype(np.int64)
    return {"cams_sq": np.sum(cams * cams, axis=0), "cams_first": cams[:2].reshape(-1),
            "pts_sq": np.sum(pts * pts, axis=0), "pts_sample": pts[idx].reshape(-1)}


def group_gap(got, ref):
    """max |got - ref| / max |ref| over one group of a digest."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    check(got.shape == ref.shape, f"shape {got.shape} != {ref.shape}")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def mesh_gaps(r, ref):
    """{group: gap} of a result against a golden or another result's
    digest: the cost, the state's digest (the gradient's for the
    evaluator)."""
    gaps = {"cost": abs(r["cost"] - ref["cost"]) / abs(ref["cost"])}
    for k, v in result_digest(r).items():
        gaps[k] = group_gap(v, ref[k])
    return gaps


def result_digest(r):
    """A tier's result's digest: its state's, the gradient's for the
    evaluator."""
    if "gradient" in r:
        g = np.asarray(r["gradient"], np.float64)
        return {"g_sq": float(np.sum(g * g)), "g_first": g[:18]}
    return mesh_digest(r["cams"], r["pts"])


def mesh_phase(bal, kn, card, paths, cards=0):
    """Port slice 19 on the card: every multi-device tier on BAL-16
    (MESH16_CASES) at world size 1 over NCCL and at 2 and 4 over gloo, the
    ranks sharing card 0, the three groups spawned at once by
    parallel.mesh.launch (the kernels built before, so the ranks load
    build/); the halo tier at the 2,048-camera instance at world size 4.
    With cards = N (port slice 20), then the NCCL group of N ranks, one
    per card, at world size N over every rank and at the smaller sizes
    of MESH_NCCL_SIZES over subgroups (tiers.run_world_sizes), the
    2,048-camera halo at world size 4. Gates, on every group: each case's
    cost within MESH_COST_REL and its state's digest within
    MESH_STATE_REL of the JAX package's (MESH16_GOLDEN) and of the same
    setting's world size 1; every rank's answer the same bits and each
    case's repeat the same bits; the point-sharded tier and the sharded
    CGNR launch their kernels (MESH_ROWS) on every rank, no plain version
    on the card; each rank's current card its own and every tensor a
    tier returned on it; each audited tier's collectives per LM
    iteration within the JAX package's audit (tiers.audit); the
    2,048-camera halo within the same bounds of the same steps on one
    device, each rank's cut (the rows it needs from other ranks) under
    half the rows it does not own; the exchange's size (n * Hs rows a
    rank) is logged, not gated. Returns the phase's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from ceres_tpu_torch.parallel import mesh as pm
    from ceres_tpu_torch.parallel import sharded_ba as tsb
    from ceres_tpu_torch.parallel import tiers

    t0 = time.monotonic()
    b = bal16(bal)
    small = bal.perturb(bal.synthetic_bal_large(**SMALL_VENICE), **VENICE_PERTURB)

    def arrays(x):
        return (x.cameras, x.points, x.camera_index, x.point_index, x.observations)

    cases = [dict(c, problem="bal16") for c in MESH16_CASES]
    c2048 = dict(name="halo_c2048", tier="halo", problem="c2048",
                 num_iterations=MESH_C2048_ITERATIONS, k=MESH_C2048_ITERATIONS, cg_iters=10)
    both = {"bal16": arrays(b), "c2048": arrays(small)}
    jobs = {n: (backend, {"bal16": arrays(b)}, cases) for n, backend in MESH_WORLD.items()}
    jobs[4] = ("gloo", both, cases + [c2048])

    def timed_launch(fn, n, backend, device, problems, *rest):
        t = time.time()
        ranks = pm.launch(fn, n, backend, device, MESH_DEADLINE_S, (problems,) + rest)
        return ranks, (t, time.time())

    with ThreadPoolExecutor(len(jobs)) as ex:
        # the ranks of every group share card 0
        futs = {n: ex.submit(timed_launch, tiers.run_cases, n, backend, "cuda:0", *job)
                for n, (backend, *job) in jobs.items()}
        # the 2,048-camera halo's one-device steps while the ranks run, and
        # how far a one-ulp change of BAL-16's cameras moves the dense-Schur
        # steps' cost after 2 LM iterations and after the phase's depth
        ref = tsb.solve_ba(small, num_iterations=MESH_C2048_ITERATIONS, cg_iters=10,
                           step="cg")
        ulp = bal.from_arrays(np.nextafter(b.cameras, np.inf), b.points, b.camera_index,
                              b.point_index, b.observations)
        depth = next(c["num_iterations"] for c in MESH16_CASES if c["name"] == "solve_ba_schur")
        sens = {}
        for k in (2, depth):
            c0, c1 = (float(tsb.solve_ba(x, num_iterations=k, step="schur").cost)
                      for x in (bal16(bal), ulp))
            sens[k] = abs(c1 - c0) / c0
        ref_digest = {"cost": float(ref.cost), **mesh_digest(ref.cams.cpu().numpy(),
                                                             ref.pts.cpu().numpy())}
        launched = {n: f.result() for n, f in futs.items()}
    wall = time.monotonic() - t0
    log("mesh sensitivity", f"solve_ba's dense-Schur step on one device: a one-ulp change of "
        f"the cameras moves the cost by {json.dumps(sens)} (relative, by LM iterations); "
        f"{card}")
    out = {n: ranks for n, (ranks, _) in launched.items()}
    for n, (ranks, (t_in, t_out)) in launched.items():
        log(f"mesh w{n}", f"{MESH_WORLD[n]}, the ranks on card 0: "
            + launch_times(ranks, t_in, t_out) + f"; {card}")
    called = set()
    for n, ranks in out.items():
        called |= gate_mesh_group(kn, "", MESH_WORLD[n], n, ranks, jobs[n][2],
                                  out[1][0]["cases"], paths, [0] * n)
    gate_halo_c2048("", out[4], ref_digest, small, paths)
    log("mesh collectives", f"called on CUDA tensors as they are, none staged through "
        f"the host by the mesh: {sorted(called)}; NCCL at world size 1, gloo at 2 and 4 "
        f"(PyTorch {torch.__version__}); {card}")
    log("mesh", f"the three groups ran in {wall:.1f} s of wall time (spawn included); {card}")
    if cards:
        nccl_phase(kn, tiers, card, paths, cards, cases, c2048, both, out, ref_digest, small,
                   timed_launch)
    return time.monotonic() - t0


def launch_times(ranks, t_in, t_out):
    """A group's launch: its seconds, the ranks' start split as
    parallel.mesh.launch records it (the slowest rank's each), the cases,
    the exit."""
    start = {k: max(r["start_seconds"].get(k, 0.0) for r in ranks)
             for k in ("spawn_to_entry", "cuda_init", "context", "process_group")}
    return (f"the group's launch {t_out - t_in:.1f} s: the ranks' start "
            f"{max(r['entered_at'] for r in ranks) - t_in:.1f} s (spawn to entry, the "
            f"interpreter, import torch, the rank's modules and arguments, "
            f"{start['spawn_to_entry']:.2f} s; CUDA's initialization in torch "
            f"{start['cuda_init']:.2f} s; the card's first context {start['context']:.2f} s; "
            f"init_process_group {start['process_group']:.2f} s: the slowest rank's each), "
            f"the cases (each run twice) {max(r['seconds'] for r in ranks):.1f} s on the "
            f"slowest rank, the ranks' exit {t_out - max(r['left_at'] for r in ranks):.1f} s")


def gate_mesh_group(kn, tag, backend, n, ranks, cases, w1, paths, cards):
    """The mesh phase's gates on one group of n ranks over `backend`:
    `ranks` their run_cases results in rank order, `cards` each rank's
    card, `w1` the cases' results at world size 1 in the same setting;
    the results go to paths["mesh_<tag><case>_w<n>"]. Returns the
    collectives the group called."""
    from ceres_tpu_torch.parallel import tiers

    names = [k.__name__ for k in kn.KERNELS]
    called = set()
    check([r["rank"] for r in ranks] == list(range(n)), f"world size {n}: ranks {ranks}")
    for rank, c in zip(ranks, cards):
        check(rank["backend"] == backend and rank["device"] == f"cuda:{c}"
              and rank["current_device"] == c,
              f"{tag}w{n}: rank {rank['rank']} on {rank['backend']}, {rank['device']}, "
              f"current card {rank['current_device']}, not {backend} on card {c}")
    for case in cases:
        name = case["name"]
        if n not in case.get("sizes", (n,)):
            continue
        first = ranks[0]["cases"][name]
        for rank, c in zip(ranks, cards):
            r = rank["cases"][name]
            called |= {k for k, v in r["collectives"].items() if v}
            check(r["repeat_bitwise"], f"mesh {tag}{name} w{n}: rank {rank['rank']}'s "
                  "repeat gave other bits")
            check(not r["plain_calls"], f"mesh {tag}{name} w{n}: plain versions ran on the "
                  f"card: {r['plain_calls']}")
            check(set(r["devices"]) <= {f"cuda:{c}"}, f"mesh {tag}{name} w{n}: rank "
                  f"{rank['rank']} returned tensors on {r['devices']}, not card {c}")
            for k in MESH_ROWS.get(name, ()):
                check(r["launches"].get(k, 0) > 0, f"mesh {tag}{name} w{n}: rank "
                      f"{rank['rank']} launched no {k}: {r['launches']}")
            check(r["cost"] == first["cost"] and all(
                np.array_equal(r[f], first[f]) for f in ("cams", "pts", "gradient")
                if f in r), f"mesh {tag}{name} w{n}: rank {rank['rank']} differs from rank 0")
            if case["tier"] in tiers.AUDITED:
                bad = tiers.audit(case["tier"], r)[1]
                check(not bad, f"mesh {tag}{name} w{n}: rank {rank['rank']} over the JAX "
                      f"package's collective audit: {bad}")
        per = (tiers.audit(case["tier"], first)[0] if case["tier"] in tiers.AUDITED else
               {k: v / first["iterations"] for k, v in first["collectives"].items()})
        paths[f"mesh_{tag}{name}_w{n}"] = {
            "launches": {k: sum(rk["cases"][name]["launches"].get(k, 0) for rk in ranks)
                         for k in names},
            "plain_calls": {k: 0 for k in names},
            "launches_by_rank": [rk["cases"][name]["launches"] for rk in ranks],
            "seconds_by_rank": [rk["cases"][name]["seconds"] for rk in ranks],
            "peak_bytes_by_rank": [rk["cases"][name]["peak_bytes"] for rk in ranks],
            "collectives_rank0": first["collectives"],
            "collectives_per_iteration": per, "iterations": first["iterations"],
            "cost": first["cost"]}
        if name == "halo_c2048":
            continue
        gaps = mesh_gaps(first, MESH16_GOLDEN[name])
        to_w1 = mesh_gaps(first, {"cost": w1[name]["cost"], **result_digest(w1[name])})
        paths[f"mesh_{tag}{name}_w{n}"].update(gaps_to_jax=gaps, gaps_to_w1=to_w1)
        log(f"mesh {tag}{name} w{n}", f"{backend}: cost {first['cost']!r}, gaps to the "
            f"JAX package's {json.dumps(gaps)}, to world size 1 {json.dumps(to_w1)}; "
            f"{max(rk['cases'][name]['seconds'] for rk in ranks):.3f} s; launches "
            f"{json.dumps(first['launches'])}; collectives {json.dumps(first['collectives'])}, "
            f"per LM iteration ({first['iterations']}) {json.dumps(per)}")
        for what, g in (("the JAX package", gaps), ("world size 1", to_w1)):
            check(g["cost"] <= MESH_COST_REL and all(
                v <= MESH_STATE_REL for k, v in g.items() if k != "cost"),
                f"mesh {tag}{name} w{n}: off {what}'s answer: {g}")
    return called


def gate_halo_c2048(tag, ranks, ref_digest, small, paths):
    """The 2,048-camera halo at world size 4 against the same steps on one
    device; a rank's cut under half the rows it does not own: the halo
    needs few of the other ranks' points (the exchange's size is only
    logged: n * Hs <= n * Pl always holds)."""
    r = ranks[0]["cases"]["halo_c2048"]
    gaps = mesh_gaps(r, ref_digest)
    cuts = [rk["cases"]["halo_c2048"]["cut_rows"] for rk in ranks]
    peaks = [rk["cases"]["halo_c2048"]["peak_bytes"] for rk in ranks]
    log(f"mesh {tag}halo_c2048 w4", f"{small.num_cameras} cameras, {small.num_points} "
        f"points, {small.num_observations} observations, {MESH_C2048_ITERATIONS} LM "
        f"iterations: plan {r['plan']}, {r['Pl']} points owned a rank, the cut (rows from "
        f"other ranks) by rank {cuts}; each exchange moves {4 * r['Hs']} rows a rank (n * "
        f"Hs, Hs the largest request, a rank's request of its own rows included) where a "
        f"gather moves {4 * r['Pl']} (n * Pl); cost {r['cost']!r}, gaps to one device "
        f"{json.dumps(gaps)}; {max(rk['cases']['halo_c2048']['seconds'] for rk in ranks):.3f}"
        f" s; peak device bytes by rank {peaks}")
    others = 3 * r["Pl"]
    check(r["plan"] == "CameraHaloPlan" and max(cuts) < others / 2,
          f"{tag}halo_c2048: the cut {cuts} is not under half the {others} rows a rank "
          "does not own")
    check(gaps["cost"] <= MESH_COST_REL and all(v <= MESH_STATE_REL for v in gaps.values()),
          f"{tag}halo_c2048: off the one-device steps: {gaps}")
    paths[f"mesh_{tag}halo_c2048_w4"].update(gaps_to_one_device=gaps, cut_rows=cuts,
                                             exchange_rows=4 * r["Hs"],
                                             gather_rows=4 * r["Pl"])


def nccl_phase(kn, tiers, card, paths, cards, cases, c2048, problems, shared, ref_digest,
               small, timed_launch):
    """The NCCL group of `cards` ranks, one per card (port slice 20): one
    launch, world size `cards` over every rank, then the smaller sizes of
    MESH_NCCL_SIZES over subgroups; the 2,048-camera halo at world size 4.
    Gated as the shared card's groups, each rank on its own card; the
    tiers' seconds logged beside the same tiers' on the shared card
    (`shared`: {world size: ranks})."""
    sizes = MESH_NCCL_SIZES[cards]
    cs = cases + ([dict(c2048, sizes=(4,))] if cards == 4 else [])
    ranks, (t_in, t_out) = timed_launch(tiers.run_world_sizes, cards, "nccl", None,
                                        problems, cs, sizes)
    out = {n: [r[n] for r in ranks if n in r] for n in sizes}
    # a rank's start from its largest group, its cases and exit over every size
    merged = [dict(r[cards], seconds=sum(x["seconds"] for x in r.values()),
                   left_at=max(x["left_at"] for x in r.values())) for r in ranks]
    log("mesh nccl", f"one rank per card, {cards} cards, world sizes {list(sizes)} from one "
        f"launch: " + launch_times(merged, t_in, t_out) + f"; {card}")
    called = set()
    for n in sizes:
        # run_world_sizes' subgroups: consecutive ranks from rank 0, the
        # sizes after the largest side by side
        first = sum(sizes[1:sizes.index(n)]) if n != cards else 0
        called |= gate_mesh_group(kn, "nccl_", "nccl", n, out[n], cs, out[1][0]["cases"],
                                  paths, list(range(first, first + n)))
    if cards == 4:
        gate_halo_c2048("nccl_", out[4], ref_digest, small, paths)
    for case in cs:
        name = case["name"]
        nccl = {n: max(r["cases"][name]["seconds"] for r in out[n]) for n in sizes
                if name in out[n][0]["cases"]}
        one = {f"{MESH_WORLD[n]} w{n}": max(r["cases"][name]["seconds"] for r in shared[n])
               for n in sorted(shared) if name in shared[n][0]["cases"]}
        log(f"mesh seconds {name}", "NCCL, one rank per card: " + ", ".join(
            f"w{n} {v:.3f} s" for n, v in sorted(nccl.items())) + "; on card 0 shared: "
            + ", ".join(f"{k} {v:.3f} s" for k, v in one.items()) + f" (first run, slowest "
            f"rank); {card}")
    log("mesh nccl collectives", f"over NCCL across cards: {sorted(called)}; {card}")


def second_card_solve(ctt, bal, kn, card, paths):
    """Port slice 20: BAL-16 DENSE_SCHUR float64 through solve() in this
    process on cuda:0, then on cuda:1 with card 0 current. Gates: the
    cuda:1 solve within 1e-6 of GOLDEN_COST, its kernels' launches those
    of the cuda:0 solve, no plain version, nothing of it allocated on
    card 0, card 0 current after it."""
    runs = {}
    for d in ("cuda:0", "cuda:1"):
        dev = torch.device(d)
        problem = bal.build_problem_batched(bal16(bal))[0]
        torch.cuda.synchronize(0)
        base0 = torch.cuda.memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)
        torch.cuda.reset_peak_memory_stats(dev)
        kn.reset_counts()
        t = time.perf_counter()
        s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
                      problem, device=d)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t
        launches, plain = counts(kn)
        runs[d] = {"cost": s.final_cost, "iterations": len(s.iterations) - 1,
                   "termination": str(s.termination_type), "seconds": seconds,
                   "launches": launches, "plain_calls": plain,
                   "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                   "card0_bytes_over_start": torch.cuda.max_memory_allocated(0) - base0}
    r0, r1 = runs["cuda:0"], runs["cuda:1"]
    gap = (r1["cost"] - GOLDEN_COST) / GOLDEN_COST
    log("solve bal16_dense_f64 cuda:1", f"cost {r1['cost']!r} (relative gap to golden "
        f"{gap:.3e}, limit 1e-6), {r1['iterations']} LM iterations, {r1['seconds']:.2f} s "
        f"(cuda:0: {r0['cost']!r}, {r0['iterations']} iterations, {r0['seconds']:.2f} s); "
        f"launches {json.dumps({k: v for k, v in r1['launches'].items() if v})}; peak "
        f"{r1['peak_device_bytes']} bytes on card 1, {r1['card0_bytes_over_start']} on "
        f"card 0 over its start; {card}")
    check(abs(gap) <= 1e-6, f"the cuda:1 solve is off golden by {gap:.3e}")
    check(r1["launches"] == r0["launches"] and not any(r1["plain_calls"].values()),
          f"the cuda:1 solve launched {r1['launches']}, cuda:0's {r0['launches']}")
    check(r1["card0_bytes_over_start"] == 0 and r1["peak_device_bytes"] > 0,
          f"the cuda:1 solve allocated {r1['card0_bytes_over_start']} bytes on card 0")
    check(torch.cuda.current_device() == 0, "card 0 is no longer current")
    paths["bal16_dense_f64_cuda1"] = dict(r1, gap_to_golden=gap)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
