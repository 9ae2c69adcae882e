"""The solve entry point: validate -> preprocess -> minimize -> summarize
(counterpart of ceres_tpu/solver.py).

`solve` runs on the CUDA device unless the caller passes device="cpu", in
which case every kernel runs its plain PyTorch version. With no CUDA
device and no device="cpu", it raises. The minimizer is picked as the
JAX package picks it (`_maybe_build_fused`): the fused loop
(solvers/fused_lm.py) for Options.fused_loop="ALWAYS", and under "AUTO"
for problems of at least `fused_loop_min_residuals` residuals in its
subset; the host loop (solvers/trust_region.py) for "NEVER", smaller
problems, user callbacks, an EvaluationCallback,
update_state_every_iteration, iteration dumps or a finite
max_solver_time_in_seconds. Both run Levenberg-Marquardt or dogleg over
DENSE_SCHUR, ITERATIVE_SCHUR (SCHUR_JACOBI, JACOBI, IDENTITY, the power
series or the cluster preconditioners, the power series' initial guess,
the explicit Schur complement), CGNR (SCHUR_JACOBI, JACOBI or IDENTITY),
DENSE_QR or DENSE_NORMAL_CHOLESKY; with check_gradients the user's
Jacobians are tested first (gradient_checker.py); the host loop alone,
as in the JAX package, runs the sparse direct solvers
SPARSE_NORMAL_CHOLESKY (the Options default; dynamic sparsity and
mixed-precision solves) and SPARSE_SCHUR, whose factorization runs on the
host (ceres_tpu_torch/native), the SUBSET preconditioner, and CGNR with
the power series or cluster preconditioners (as IDENTITY). DOGLEG with an iterative solver fails validation as in
the JAX package; a Schur solver on a problem without eliminable blocks
falls back as the JAX package's does. Anything else raises
NotImplementedError naming the later slice (types.not_ported).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .options import Options
from .problem import Problem
from .program import CompiledProgram, resolve_device
from .solvers.fused_lm import build_fused_minimizer
from .summary import Summary
from .types import LinearSolverType, PreconditionerType, TerminationType


def _pick_linear_solver(options: Options, program: CompiledProgram,
                        summary: Summary):
    """SetupLinearSolver (trust_region_preprocessor.cc:161-259, the JAX
    solver.py:29-86) with the fallback of a Schur solver on a problem
    without e-blocks (LinearSolverForZeroEBlocks): DENSE_SCHUR takes
    DENSE_QR, SPARSE_SCHUR takes SPARSE_NORMAL_CHOLESKY, ITERATIVE_SCHUR
    takes CGNR. Sets the summary's solver used; returns (tier, e_families
    or None)."""
    from .utils import ordering as ordering_mod

    LS = LinearSolverType
    given = used = options.linear_solver_type
    e_fams = None
    if given in (LS.DENSE_SCHUR, LS.SPARSE_SCHUR, LS.ITERATIVE_SCHUR):
        if options.linear_solver_ordering is not None:
            e_fams = ordering_mod.e_set_from_user_ordering(
                program, options.linear_solver_ordering) or None
        else:
            e_fams = ordering_mod.eligible_e_sets(program) or None
        if e_fams:
            summary.schur_structure_given = summary.schur_structure_used = (
                _schur_structure_string(program, e_fams))
        else:
            used = {LS.DENSE_SCHUR: LS.DENSE_QR, LS.SPARSE_SCHUR: LS.SPARSE_NORMAL_CHOLESKY,
                    LS.ITERATIVE_SCHUR: LS.CGNR}[given]
    tier = {LS.DENSE_SCHUR: "schur_dense", LS.SPARSE_SCHUR: "schur_sparse",
            LS.ITERATIVE_SCHUR: "schur_iterative", LS.CGNR: "bsr",
            LS.SPARSE_NORMAL_CHOLESKY: "bsr_sparse", LS.DENSE_QR: "dense_qr",
            LS.DENSE_NORMAL_CHOLESKY: "dense_normal_cholesky"}[used]
    summary.linear_solver_type_used = used
    return tier, e_fams


def _preconditioner_used(used: LinearSolverType,
                         options: Options) -> PreconditionerType:
    """As the JAX solver reports it (solver.py:310-313): the given type for
    an iterative solver, IDENTITY for an exact one. The iterative-Schur
    step runs JACOBI as SCHUR_JACOBI (fused_lm.py:237-239)."""
    if used in (LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.CGNR):
        return options.preconditioner_type
    return PreconditionerType.IDENTITY


def _schur_structure_string(program, e_fams) -> str:
    def uniq(vals):
        vals = set(vals)
        return str(vals.pop()) if len(vals) == 1 else "d"

    e_set = set(e_fams)
    rows = [k.r for k in program.kinds]
    e_sizes = [program.families[fi].tsize for fi in e_fams]
    f_sizes = [f.tsize for i, f in enumerate(program.families)
               if i not in e_set and f.num_var]
    return f"{uniq(rows)},{uniq(e_sizes)},{uniq(f_sizes)}"


def _maybe_build_fused(options: Options, program: CompiledProgram, tier: str, e_fams):
    """The fused minimizer where the configuration is in its subset, None
    for the host loop (solver.py:122-171): the sparse tiers, which factor
    on the host, always take the host loop."""
    mode = options.fused_loop.upper()
    if mode == "NEVER" or tier in ("bsr_sparse", "schur_sparse"):
        return None
    if mode == "AUTO" and program.num_residuals < options.fused_loop_min_residuals:
        return None
    if (options.callbacks or options.update_state_every_iteration
            or options.evaluation_callback is not None
            or options.trust_region_minimizer_iterations_to_dump
            or options.max_solver_time_in_seconds < 1e6):
        return None
    return build_fused_minimizer(program, options, tier, e_families=e_fams)


def _host_minimizer(options: Options, program: CompiledProgram, tier: str, e_fams,
                    summary: Summary):
    """The host loop over its kernels (solver.py:323-402):
    DenseTrustRegionKernels for DENSE_QR and DENSE_NORMAL_CHOLESKY,
    BlockTrustRegionKernels for the rest."""
    from .solvers.bsr_kernels import BlockTrustRegionKernels
    from .solvers.linear import dense as dense_mod
    from .solvers.trust_region import DenseTrustRegionKernels, TrustRegionMinimizer

    if tier in ("dense_qr", "dense_normal_cholesky"):
        solve_fn = dense_mod.qr_solve if tier == "dense_qr" else dense_mod.normal_cholesky_solve
        if tier == "dense_normal_cholesky" and options.use_mixed_precision_solves:
            steps = max(1, options.max_num_refinement_iterations)

            def solve_fn(J, r, D):
                return dense_mod.normal_cholesky_solve_mixed(J, r, D, refinement_steps=steps)

        kernels = DenseTrustRegionKernels(program, solve_fn, options)
    else:
        step_solver = {"bsr": "CGNR", "schur_dense": "DENSE_SCHUR",
                       "schur_iterative": "ITERATIVE_SCHUR",
                       "bsr_sparse": "SPARSE_NORMAL_CHOLESKY",
                       "schur_sparse": "SPARSE_SCHUR"}[tier]
        kernels = BlockTrustRegionKernels(program, options, step_solver, e_families=e_fams)
    return TrustRegionMinimizer(program, kernels, options, summary)


def _solve_mixed(options: Options, problem: Problem, summary: Summary,
                 t_start: float, device) -> Summary:
    """evaluation_dtype="mixed" (solver.py:172-210): a float32 solve to its
    own end, then up to mixed_precision_polish_iterations float64
    iterations from its answer. The summary joins both phases: the first
    one's initial cost and rows, then the second one's rows, steps and
    result. The two phases share one iterate, the float32 answer, which
    the JAX package's merged summary holds twice (as the float64 phase's
    row 0, counted as a successful step again); here the merged rows and
    step counts hold it once, and each phase keeps its own iteration
    numbers."""
    import dataclasses

    s32 = solve(dataclasses.replace(options, evaluation_dtype="float32"), problem,
                Summary(), device)
    if not s32.is_solution_usable():
        summary.__dict__.update(s32.__dict__)
        return summary
    polish = min(options.mixed_precision_polish_iterations, options.max_num_iterations)
    s64 = solve(dataclasses.replace(options, evaluation_dtype="float64",
                                    max_num_iterations=polish), problem, Summary(), device)
    summary.__dict__.update(s64.__dict__)
    summary.initial_cost = s32.initial_cost
    summary.iterations = list(s32.iterations) + list(s64.iterations[1:])
    # s64's row 0, the shared iterate, counted as a successful step there
    summary.num_successful_steps = s32.num_successful_steps + s64.num_successful_steps - 1
    summary.num_unsuccessful_steps = (s32.num_unsuccessful_steps
                                      + s64.num_unsuccessful_steps)
    summary.num_host_syncs = s32.num_host_syncs + s64.num_host_syncs
    summary.minimizer_time_in_seconds = (s32.minimizer_time_in_seconds
                                         + s64.minimizer_time_in_seconds)
    summary.total_time_in_seconds = time.monotonic() - t_start
    summary.message = (f"mixed-precision schedule: f32 phase "
                       f"({len(s32.iterations)} its) + f64 polish "
                       f"({len(s64.iterations)} its). " + s64.message)
    return summary


def solve(options: Options, problem: Problem, summary: Optional[Summary] = None,
          device=None) -> Summary:
    """ceres::Solve (solver.h:1119): minimizes, writes the solution back
    into the problem's parameter arrays and returns the summary."""
    dev = resolve_device(device)
    if summary is None:
        summary = Summary()
    t_start = time.monotonic()

    ok, msg = options.is_valid()
    if not ok:
        summary.message = msg
        summary.termination_type = TerminationType.FAILURE
        return summary
    options.check_supported()
    if options.evaluation_dtype == "mixed":
        return _solve_mixed(options, problem, summary, t_start, dev)

    summary.minimizer_type = options.minimizer_type
    summary.num_threads_given = options.num_threads
    summary.num_threads_used = 1
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.num_parameter_blocks = problem.num_parameter_blocks()
    summary.num_parameters = problem.num_parameters()
    summary.num_residual_blocks = problem.num_residual_blocks()
    summary.num_residuals = problem.num_residuals()
    summary.num_effective_parameters = sum(b.tangent_size
                                           for b in problem.parameter_blocks())
    summary.device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu")
    summary.num_devices = 1

    if options.check_gradients:
        from .gradient_checker import check_problem_gradients

        ok, msg = check_problem_gradients(
            problem, relative_precision=options.gradient_check_relative_precision,
            relative_step_size=options.gradient_check_numeric_derivative_relative_step_size)
        if not ok:
            summary.message = msg
            summary.termination_type = TerminationType.FAILURE
            return summary

    program = CompiledProgram(problem, options.evaluation_dtype, device=dev)
    summary.fixed_cost = program.fixed_cost
    summary.num_parameter_blocks_reduced = sum(f.count for f in program.families)
    summary.num_parameters_reduced = program.state_size
    summary.num_effective_parameters_reduced = program.tangent_size
    summary.num_residual_blocks_reduced = sum(k.B for k in program.kinds)
    summary.num_residuals_reduced = program.num_residuals
    summary.is_constrained = program.has_bounds()

    if program.num_residuals == 0 or program.tangent_size == 0:
        # nothing to optimize (solver.py:270-281)
        cost = program.fixed_cost
        if program.num_residuals:
            cost = float(program.evaluate_cost(program.initial_state()))
        summary.initial_cost = summary.final_cost = cost
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = ("Function tolerance reached. No non-constant "
                           "parameter blocks found.")
        summary.total_time_in_seconds = time.monotonic() - t_start
        return summary

    tier, e_fams = _pick_linear_solver(options, program, summary)
    summary.preconditioner_type_used = _preconditioner_used(
        summary.linear_solver_type_used, options)
    minimizer = _maybe_build_fused(options, program, tier, e_fams)
    host = minimizer is None
    if host:
        minimizer = _host_minimizer(options, program, tier, e_fams, summary)
    summary.preprocessor_time_in_seconds = time.monotonic() - t_start

    t_min = time.monotonic()
    if host:
        x_final = minimizer.minimize(program.initial_state())
    else:
        x_final = minimizer.minimize(program.initial_state(), summary)
    summary.minimizer_time_in_seconds = time.monotonic() - t_min

    t_post = time.monotonic()
    program.write_state(x_final)
    if np.isfinite(minimizer.x_cost):
        summary.final_cost = minimizer.x_cost
    summary.postprocessor_time_in_seconds = time.monotonic() - t_post
    summary.total_time_in_seconds = time.monotonic() - t_start
    return summary
