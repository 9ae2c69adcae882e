"""The solve entry point: validate -> preprocess -> minimize -> summarize
(counterpart of ceres_tpu/solver.py).

`solve` runs on the CUDA device unless the caller passes device="cpu", in
which case every kernel runs its plain PyTorch version. With no CUDA
device and no device="cpu", it raises. The slice's configuration is a
DENSE_SCHUR Levenberg-Marquardt solve in the fused-loop form; anything
else raises NotImplementedError naming the later slice (types.not_ported).
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
from .types import LinearSolverType, PreconditionerType, TerminationType, not_ported


def _pick_linear_solver(options: Options, program: CompiledProgram,
                        summary: Summary):
    """SetupLinearSolver for DENSE_SCHUR (trust_region_preprocessor.cc):
    returns (tier, e_families)."""
    from .utils import ordering as ordering_mod

    if options.linear_solver_type != LinearSolverType.DENSE_SCHUR:
        raise not_ported(f"linear_solver_type={options.linear_solver_type}", 6)
    e_fams = ordering_mod.eligible_e_sets(program)
    if not e_fams:
        # the DENSE_QR fallback for a problem without e-blocks
        raise not_ported("DENSE_SCHUR without eliminable blocks (DENSE_QR)", 6)
    summary.schur_structure_given = summary.schur_structure_used = (
        _schur_structure_string(program, e_fams))
    return "schur_dense", e_fams


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

    summary.minimizer_type = options.minimizer_type
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.num_parameter_blocks = problem.num_parameter_blocks()
    summary.num_parameters = problem.num_parameters()
    summary.num_residual_blocks = problem.num_residual_blocks()
    summary.num_residuals = problem.num_residuals()
    summary.device_kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                           else "cpu")
    summary.num_devices = 1

    program = CompiledProgram(problem, options.evaluation_dtype, device=dev)
    summary.fixed_cost = program.fixed_cost
    summary.num_parameters_reduced = program.state_size
    summary.num_effective_parameters_reduced = program.tangent_size
    summary.num_residuals_reduced = program.num_residuals

    if program.num_residuals == 0 or program.tangent_size == 0:
        summary.initial_cost = summary.final_cost = program.fixed_cost
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = ("Function tolerance reached. No non-constant "
                           "parameter blocks found.")
        summary.total_time_in_seconds = time.monotonic() - t_start
        return summary

    tier, e_fams = _pick_linear_solver(options, program, summary)
    summary.linear_solver_type_used = options.linear_solver_type
    summary.preconditioner_type_used = PreconditionerType.IDENTITY
    fused = build_fused_minimizer(program, options, tier, e_families=e_fams)
    summary.preprocessor_time_in_seconds = time.monotonic() - t_start

    t_min = time.monotonic()
    x_final = fused.minimize(program.initial_state(), summary)
    summary.minimizer_time_in_seconds = time.monotonic() - t_min

    t_post = time.monotonic()
    program.write_state(x_final)
    if np.isfinite(fused.x_cost):
        summary.final_cost = fused.x_cost
    summary.postprocessor_time_in_seconds = time.monotonic() - t_post
    summary.total_time_in_seconds = time.monotonic() - t_start
    return summary
