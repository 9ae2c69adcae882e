"""The port's small example scripts (ceres_tpu_torch/examples/) against
the JAX package's (ceres_tpu/examples/) with the same arguments on the
CPU: each solve's final cost within 1e-10 relative (or 1e-12 x the
initial cost where the JAX one lies below that), the same iteration count
and termination type, every parameter block within 1e-8 x max(1, its
largest magnitude), and the same printed lines, numbers aside
(tests/torch_examples.py). Scripts of the models and of bundle adjustment
are in test_torch_examples_models.py and test_torch_examples_ba.py."""
import importlib

import pytest
import torch

from torch_examples import assert_pair, assert_same_lines, run_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = [
    ("helloworld", []),
    ("helloworld", ["--diff", "analytic"]),
    ("helloworld", ["--diff", "numeric"]),
    ("powell", []),
    ("curve_fitting", []),
    ("curve_fitting", ["--robust"]),
    ("circle_fit", []),
    ("circle_fit", ["--robust_threshold", "1.0"]),
    ("robot_pose_mle", []),
    ("rosenbrock", []),
    ("rosenbrock", ["--diff", "analytic"]),
    ("rosenbrock", ["--diff", "numeric"]),
    ("callbacks_example", []),
    ("evaluation_callback_example", []),
    ("libmv_homography", []),
    ("sampled_function", []),
    ("bicubic_interpolation", []),
]


@pytest.mark.parametrize("name,argv", SMALL,
                         ids=[" ".join([n] + a) for n, a in SMALL])
def test_small_example_matches_jax(monkeypatch, capsys, name, argv):
    calls_j, calls_t, out = run_pair(monkeypatch, name, argv, capsys)
    assert_pair(calls_j, calls_t)
    assert_same_lines(*out)


@pytest.mark.parametrize("name,prefix", [
    ("callbacks_example", "evaluation callback prepared"),
    ("evaluation_callback_example", "callback:"),
])
def test_callback_counts_match_jax(monkeypatch, capsys, name, prefix):
    """The line in which each callback script prints how often its
    EvaluationCallback was prepared (and saw a new point, or how many
    iteration callbacks ran) is the JAX script's, numbers included: the
    port calls the callbacks as often, in the same places."""
    _, _, out = run_pair(monkeypatch, name, [], capsys)
    lines = [[line for line in o.splitlines() if line.startswith(prefix)] for o in out]
    assert len(lines[0]) == 1 and lines[1] == lines[0]


@pytest.mark.parametrize("argv", [["helloworld"], ["rosenbrock"],
                                  ["more_garbow_hillstrom", "--problem", "1"],
                                  ["bundle_adjuster", "--num_points", "50"]],
                         ids=lambda a: a[0])
def test_example_without_device_runs_on_the_card_or_raises(argv):
    """Without --device a script asks for the card (the default cuda), and
    where there is none it raises: nothing falls back to the CPU."""
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    main = importlib.import_module(f"ceres_tpu_torch.examples.{argv[0]}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv[1:])
