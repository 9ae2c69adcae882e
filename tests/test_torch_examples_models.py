"""The port's example scripts over its models and sparse solvers against
the JAX package's with the same arguments on the CPU, held as in
test_torch_examples_small.py: more_garbow_hillstrom.py (models/mgh.py),
the pose graphs on their synthetic graphs (models/pose_graph.py) and
ellipse_approximation.py (SPARSE_NORMAL_CHOLESKY with dynamic sparsity on
and off), the last at 100 points and 50 segments where its default of 212
and 151 takes a minute."""
import pytest

from torch_examples import assert_pair, assert_same_lines, run_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODELS = [
    ("more_garbow_hillstrom", ["--problem", "1"]),
    ("more_garbow_hillstrom", ["--problem", "4", "--trials", "0,1"]),
    ("pose_graph_2d", []),
    ("pose_graph_3d", []),
    ("ellipse_approximation", ["--num_points", "100", "--num_segments", "50"]),
]


@pytest.mark.parametrize("name,argv", MODELS,
                         ids=[" ".join([n] + a) for n, a in MODELS])
def test_model_example_matches_jax(monkeypatch, capsys, name, argv):
    calls_j, calls_t, out = run_pair(monkeypatch, name, argv, capsys)
    assert_pair(calls_j, calls_t)
    assert_same_lines(*out)


def test_constrained_mgh_example_parts_at_rounding(monkeypatch, capsys):
    """more_garbow_hillstrom.py --problem 7 --constrained (Helical valley in
    its certified box; tolerances of 1e-18, so the solve runs to machine
    precision). Witness: both packages' rows agree to 1.2e-15 relative
    through row 12; at row 13 the JAX loop rejects a step whose cost change
    is -1.1e-16 where the port accepts one of +5.6e-17, and the two end
    after 18 and 16 rows, both in CONVERGENCE (function tolerance in the
    JAX package, parameter tolerance in the port) at final costs 1.1e-16
    apart, the parameters 2.6e-9 apart. So its rows are held up to row 13,
    its final cost to 1e-8, its parameters and printed lines as every other
    script's."""
    calls_j, calls_t, out = run_pair(monkeypatch, "more_garbow_hillstrom",
                                     ["--problem", "7", "--constrained"], capsys)
    assert_pair(calls_j, calls_t, parts=[13])
    assert_same_lines(*out)
