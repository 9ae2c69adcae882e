"""Mixed precision in the port, against ceres_tpu on the
same inputs: normal_cholesky_solve_mixed (a float32 Cholesky with float64
refinement), the mixed dense-Schur step (a float32 factor of the reduced
system refined in float64 through the flat products; it leaves the jt
path), and evaluation_dtype="mixed" (a float32 solve, then a float64
polish), phase by phase. Each tolerance is stated where it is used."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.solvers.linear import dense as jdense

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.ops import partition as pt
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.linear import dense as tdense
from ceres_tpu_torch.utils import ordering
from test_torch_dense_solvers import rel_err, systems


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", ["problem_0", "problem_1", "problem_2", "random"])
def test_normal_cholesky_solve_mixed_matches_jax(name, steps):
    """The float32 factor's answer after `steps` float64 refinements: to
    1e-6 relative of the JAX function's after one (the two float32
    factors round differently), 1e-12 after three; and float64 out."""
    p = systems()[name]
    out = tdense.normal_cholesky_solve_mixed(torch.as_tensor(p.J), torch.as_tensor(p.b),
                                             torch.as_tensor(p.D), refinement_steps=steps)
    ref = jdense.normal_cholesky_solve_mixed(jnp.asarray(p.J), jnp.asarray(p.b),
                                             jnp.asarray(p.D), refinement_steps=steps)
    assert out.dtype == torch.float64
    assert rel_err(out, ref) <= (1e-6 if steps == 1 else 1e-12)


def small_ba():
    return tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=80, visibility=0.5,
                                           seed=3), 0.01, 0.05, 0.2)


def _arrays(b):
    return (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
            b.point_index.copy(), b.observations.copy())


def _pair(b, lst, **kw):
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType[lst],
                              fused_loop="ALWAYS", **kw),
                   jbal.build_problem_batched(jbal.BALProblem(*_arrays(b)))[0])
    kn.reset_counts()
    out = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                linear_solver_type=ctt.LinearSolverType[lst], **kw),
                    tbal.build_problem_batched(tbal.BALProblem(*_arrays(b)))[0],
                    device="cpu")
    return ref, out, {k.__name__: k.plain_calls for k in kn.KERNELS}


def test_mixed_solves_leave_the_jt_path():
    """jt_refusal turns mixed-precision solves away from the jt path, as
    the JAX loop does (fused_lm.py:295, :628, :982)."""
    b = small_ba()
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], device="cpu")
    pm = pt.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
    assert fo.jt_refusal(pm, prog) is None
    assert fo.jt_refusal(pm, prog, ctt.Options(use_mixed_precision_solves=True)) == (
        "mixed-precision solves")


@pytest.mark.parametrize("refine", [0, 3])
def test_mixed_solves_dense_schur_match_jax(refine):
    """Path (d): DENSE_SCHUR, float64, use_mixed_precision_solves, on the
    flat path (rows 6-9's plain versions). With 3 refinements the step is
    the float64 one to rounding: the same termination and rows, each
    row's cost to 1e-9 relative. With the default one (refine 0 -> 1),
    the two packages' float32 factors, which round differently, leave
    ~1e-8 relative in a row's cost far from the minimum: the same
    termination and number of rows, each row's cost to 1e-7."""
    ref, out, calls = _pair(small_ba(), "DENSE_SCHUR", use_mixed_precision_solves=True,
                            max_num_refinement_iterations=refine)
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations)
    rel = 1e-9 if refine == 3 else 1e-7
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel)
    assert calls["eval_fused"] == 0 and calls["schur_assembly"] == 0
    for name in ("segment_block_sum", "segment_block_expand", "segment_spread_sum"):
        assert calls[name] > 0, name


def _phases(summary):
    """(rows of the float32 phase, rows of the float64 polish) of a mixed
    summary, split at the float32 phase's row count in its message."""
    n32 = int(re.search(r"f32 phase \((\d+) its\)", summary.message).group(1))
    return summary.iterations[:n32], summary.iterations[n32:]


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_mixed_evaluation_matches_jax_phase_by_phase(lst):
    """Path (c), evaluation_dtype="mixed", phase by phase. The float32
    phase: the same start and a lowest cost within 1e-5 of the JAX one
    (its rows follow float32 rounding; the port also sums a float32
    evaluation's cost in float64). The float64 polish: a final cost
    within 1e-6 of the JAX one. The JAX summary holds the iterate the
    phases share twice; the port's once: its polish rows are the JAX
    count less one."""
    ref, out, _ = _pair(small_ba(), lst, evaluation_dtype="mixed")
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    j32, j64 = _phases(ref)
    t32, t64 = _phases(out)
    assert t32[0].cost == pytest.approx(j32[0].cost, rel=1e-5)
    assert out.initial_cost == pytest.approx(ref.initial_cost, rel=1e-5)
    assert min(r.cost for r in t32) == pytest.approx(min(r.cost for r in j32), rel=1e-5)
    n64 = int(re.search(r"f64 polish \((\d+) its\)", out.message).group(1))
    assert len(t64) == n64 - 1 and len(j64) == int(
        re.search(r"f64 polish \((\d+) its\)", ref.message).group(1))
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-6)


def test_mixed_summary_joins_its_phases():
    """The merged summary is the float32 solve, then the float64 polish
    from its answer, the shared iterate once: rows, successful steps and
    host syncs add up, the final cost is the polish's."""
    b = small_ba()
    opts = dict(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    p = tbal.build_problem_batched(tbal.BALProblem(*_arrays(b)))[0]
    mixed = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                  evaluation_dtype="mixed", **opts), p, device="cpu")
    p = tbal.build_problem_batched(tbal.BALProblem(*_arrays(b)))[0]
    s32 = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                evaluation_dtype="float32", **opts), p, device="cpu")
    s64 = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                evaluation_dtype="float64", max_num_iterations=5, **opts),
                    p, device="cpu")
    assert [r.cost for r in mixed.iterations] == (
        [r.cost for r in s32.iterations] + [r.cost for r in s64.iterations[1:]])
    assert mixed.num_successful_steps == s32.num_successful_steps + s64.num_successful_steps - 1
    assert mixed.num_host_syncs == s32.num_host_syncs + s64.num_host_syncs
    assert mixed.final_cost == s64.final_cost
    assert mixed.initial_cost == s32.initial_cost


def test_progress_lines_match_jax(capsys):
    """minimizer_progress_to_stdout prints one trust_region_log_line per
    row after the solve, in the JAX format (callbacks.py:32-52)."""
    from ceres_tpu.callbacks import trust_region_log_line as jline

    b = small_ba()
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                              linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                              minimizer_progress_to_stdout=True),
                  tbal.build_problem_batched(tbal.BALProblem(*_arrays(b)))[0], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [jline(ct.IterationSummary(**vars(r))) for r in s.iterations]
