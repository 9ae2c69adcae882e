"""Runs an example script of the JAX package and its twin in the port with
the same arguments on the CPU, and holds the pair to each other, for the
test_torch_examples_*.py files.

The JAX script runs unchanged: `sys.argv` is set for it, and the module
attribute each solve goes through (`ceres_tpu.solve`, `models.mgh.solve`,
the rosenbrock script's `solve_gradient_problem`) is wrapped so that it
records each summary with the Problem, or the parameter array, it solved.
The port's script runs through `main(argv + ["--device", "cpu"])` under
the same wrapping, and returns the summaries it made. Standard input is
empty for both (circle_fit.py reads its points from a pipe). Both
scripts print the same lines, numbers aside (`skeleton`)."""
import importlib
import io
import re
import sys

import numpy as np

import ceres_tpu
import ceres_tpu.models.mgh
import ceres_tpu_torch
import ceres_tpu_torch.models.mgh

# the final cost within REL of the JAX one, or within ABS_OF_INITIAL x the
# initial cost where the JAX one lies below that
REL = 1e-10
ABS_OF_INITIAL = 1e-12
# a trajectory that follows rounding: its final cost within PARTED_REL
PARTED_REL = 1e-8
# each parameter within PARAM_TOL x max(1, its block's largest magnitude)
PARAM_TOL = 1e-8
# bundle adjustment has gauge freedom: its residuals are held instead,
# each within RESIDUAL_TOL x max(1, the largest magnitude)
RESIDUAL_TOL = 1e-8


def _record(monkeypatch, pkg, name):
    """Wrap the solve entry points the script `name` of package `pkg`
    reaches; returns the list each (summary, solved thing) lands in."""
    calls = []
    if name == "rosenbrock":
        mod = importlib.import_module(f"{pkg.__name__}.examples.rosenbrock")
        inner = mod.solve_gradient_problem

        def wrapped(options, problem, x, *a, **kw):
            s = inner(options, problem, x, *a, **kw)
            calls.append((s, x))
            return s

        monkeypatch.setattr(mod, "solve_gradient_problem", wrapped)
        return calls
    mgh = ceres_tpu.models.mgh if pkg is ceres_tpu else ceres_tpu_torch.models.mgh
    for owner in (pkg, mgh):
        inner = owner.solve

        def wrapped(options, problem, *a, _inner=inner, **kw):
            s = _inner(options, problem, *a, **kw)
            calls.append((s, problem))
            return s

        monkeypatch.setattr(owner, "solve", wrapped)
    return calls


def run_pair(monkeypatch, name, argv, capsys=None):
    """Runs the JAX script `name` and the port's with `argv`; returns the
    two lists of (summary, problem or parameter array), in solve order,
    and (if capsys is given) the two scripts' standard outputs."""
    argv = list(argv)
    out = []
    with monkeypatch.context() as m:
        calls_j = _record(m, ceres_tpu, name)
        m.setattr(sys, "argv", [name] + argv)
        m.setattr(sys, "stdin", io.StringIO(""))
        importlib.import_module(f"ceres_tpu.examples.{name}").main()
    if capsys is not None:
        out.append(capsys.readouterr().out)
    with monkeypatch.context() as m:
        calls_t = _record(m, ceres_tpu_torch, name)
        m.setattr(sys, "stdin", io.StringIO(""))
        ret = importlib.import_module(f"ceres_tpu_torch.examples.{name}").main(
            argv + ["--device", "cpu"])
    if capsys is not None:
        out.append(capsys.readouterr().out)
    returned = ret if isinstance(ret, list) else [ret]
    assert [id(s) for s in returned] == [id(s) for s, _ in calls_t], \
        "main() did not return the summaries its solves made"
    return calls_j, calls_t, out


def assert_same_solve(sj, st):
    """The final cost to REL (or ABS_OF_INITIAL x the initial cost), the
    same iteration count and termination type."""
    assert str(st.termination_type) == str(sj.termination_type), (
        st.termination_type, sj.termination_type, st.message, sj.message)
    assert len(st.iterations) == len(sj.iterations), (
        len(st.iterations), len(sj.iterations))
    floor = ABS_OF_INITIAL * abs(sj.initial_cost)
    tol = floor if abs(sj.final_cost) < floor else REL * abs(sj.final_cost)
    assert abs(st.final_cost - sj.final_cost) <= tol, (st.final_cost, sj.final_cost)


def parameter_values(problem):
    """The values of a problem's parameter blocks, or the parameter array
    of a gradient problem, in add order."""
    if isinstance(problem, np.ndarray):
        return [problem]
    return [np.asarray(b.values) for b in problem.parameter_blocks()]


def assert_same_parameters(pj, pt):
    vj, vt = parameter_values(pj), parameter_values(pt)
    assert len(vj) == len(vt)
    for a, b in zip(vj, vt):
        tol = PARAM_TOL * max(1.0, float(np.max(np.abs(a))))
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def assert_same_residuals(pj, pt):
    """The residuals at the two solutions, in the residual blocks' add
    order (the BA scripts, whose parameters have gauge freedom)."""
    rj = np.asarray(pj.evaluate(residuals=True)[1])
    rt = np.asarray(pt.evaluate(residuals=True, device="cpu")[1])
    tol = RESIDUAL_TOL * max(1.0, float(np.max(np.abs(rj))))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=tol)


def assert_parted_solve(sj, st, part):
    """A trajectory that follows rounding: the rows before `part`, the row
    where the two packages part (witnessed beside the test), within REL;
    the same termination type; the final cost within PARTED_REL (or
    ABS_OF_INITIAL x the initial cost)."""
    assert str(st.termination_type) == str(sj.termination_type), (
        st.termination_type, sj.termination_type, st.message, sj.message)
    assert min(len(st.iterations), len(sj.iterations)) >= part
    for a, b in zip(sj.iterations[:part], st.iterations[:part]):
        assert abs(b.cost - a.cost) <= REL * abs(a.cost), (a.iteration, b.cost, a.cost)
    floor = ABS_OF_INITIAL * abs(sj.initial_cost)
    tol = floor if abs(sj.final_cost) < floor else PARTED_REL * abs(sj.final_cost)
    assert abs(st.final_cost - sj.final_cost) <= tol, (st.final_cost, sj.final_cost)


def assert_pair(calls_j, calls_t, gauge=False, parts=None):
    """Every solve of the pair: the same count, each as assert_same_solve,
    or as assert_parted_solve where `parts` gives the row where it parts,
    and the parameters; with gauge freedom the residuals instead, unless
    the trajectory parted."""
    assert len(calls_t) == len(calls_j) >= 1
    parts = parts or [None] * len(calls_j)
    for (sj, pj), (st, pt), part in zip(calls_j, calls_t, parts):
        if part is None:
            assert_same_solve(sj, st)
        else:
            assert_parted_solve(sj, st, part)
        if not gauge:
            assert_same_parameters(pj, pt)
        elif part is None:
            assert_same_residuals(pj, pt)


_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|\bnan\b|\binf\b")


def skeleton(text):
    """The printed lines with every number as '#', runs of blanks as one,
    the port's names as the JAX package's and the port's own line of host
    syncs left out: what two runs of a script print alike."""
    lines = []
    for line in text.splitlines():
        if line.startswith("Host syncs"):
            continue
        line = line.replace("Ceres-TPU-Torch", "Ceres-TPU").replace("ceres_tpu_torch",
                                                                    "ceres_tpu")
        lines.append(" ".join(_NUMBER.sub("#", line).split()))
    return lines


def assert_same_lines(out_j, out_t):
    assert skeleton(out_t) == skeleton(out_j)
