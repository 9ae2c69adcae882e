"""ceres_tpu_torch.tiny_solver against ceres_tpu.tiny_solver on the same
numpy inputs (the twins of tests/test_satellite_apis.py's two TinySolver
tests, :154 and :164), on the CPU: x within 1e-12 and the same iteration
counts, lane by lane; every lane of a batch ends where its own `solve`
ends; one host sync an iteration."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu import rotation as jrot

import ceres_tpu_torch as ctt
from ceres_tpu_torch import rotation as trot

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


def _rosenbrock_t(x, data):
    return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def _rosenbrock_j(x, data):
    return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def test_tiny_solver_single_matches_jax():
    ts = ctt.TinySolver(_rosenbrock_t, device="cpu")
    x, s = ts.solve(np.array([-1.2, 1.0]))
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-6)
    assert float(s.final_cost) < 1e-12
    xj, sj = ct.TinySolver(_rosenbrock_j).solve(jnp.asarray([-1.2, 1.0]))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    assert int(s.iterations) == int(sj.iterations)
    assert abs(float(s.initial_cost) - float(sj.initial_cost)) <= 1e-15 * float(sj.initial_cost)
    assert ts.last_host_syncs == int(s.iterations)
    assert isinstance(s, ctt.TinySolverSummary) and s.final_cost.dtype == torch.float64


def test_tiny_solver_batch_matches_jax():
    """64 curve fits in one loop (test_tiny_solver_batch's), lane by lane
    against the JAX solve_batch, and the lanes against their own solves."""
    B = 64
    rng = np.random.default_rng(1)
    true_ab = rng.uniform(0.5, 2.0, (B, 2))
    ts_x = np.linspace(0, 1, 8)
    ys = true_ab[:, :1] * np.exp(true_ab[:, 1:] * ts_x[None, :])
    tx = torch.as_tensor(ts_x)
    solver = ctt.TinySolver(lambda ab, y: y - ab[0] * torch.exp(ab[1] * tx), device="cpu")
    xs, s = solver.solve_batch(np.ones((B, 2)), ys)
    np.testing.assert_allclose(xs.numpy(), true_ab, rtol=1e-4)
    assert bool((s.final_cost < 1e-10).all())
    assert solver.last_host_syncs == int(s.iterations.max())
    xj, sj = ct.TinySolver(
        lambda ab, y: y - ab[0] * jnp.exp(ab[1] * jnp.asarray(ts_x))).solve_batch(
            jnp.ones((B, 2)), jnp.asarray(ys))
    np.testing.assert_allclose(xs.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(s.iterations.numpy(), np.asarray(sj.iterations))
    for i in (0, 7, 63):
        x1, s1 = solver.solve(np.ones(2), ys[i])
        np.testing.assert_allclose(x1.numpy(), xs[i].numpy(), rtol=0, atol=1e-14)
        assert int(s1.iterations) == int(s.iterations[i])


def test_tiny_solver_triangulations_match_jax():
    """chip_smoke.py's TinySolver lanes (4 views, 8 residuals) at 256 lanes:
    x within 1e-12 of the JAX solve_batch's and of the truth within 1e-6
    (the lanes stop once the cost is below float64's eps, the residuals
    ~1e-8), the same iterations, the final cost within 1e-12 of the
    initial."""
    X, x0, cams, obs = chip_smoke.triangulations(256, seed=3)
    solver = ctt.TinySolver(chip_smoke.triangulation_residual(trot), device="cpu")
    x, s = solver.solve_batch(x0, (cams, obs))
    xj, sj = ct.TinySolver(chip_smoke.triangulation_residual(jrot)).solve_batch(
        jnp.asarray(x0), (jnp.asarray(cams), jnp.asarray(obs)))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(s.iterations.numpy(), np.asarray(sj.iterations))
    assert np.abs(x.numpy() - X).max() <= 1e-6
    np.testing.assert_allclose(s.final_cost.numpy(), np.asarray(sj.final_cost), rtol=0,
                               atol=1e-12 * float(s.initial_cost.max()))
    assert solver.last_host_syncs == int(s.iterations.max())


def test_tiny_solver_frozen_lane_and_options():
    """A lane whose start is not finite is done at once and keeps its start
    (the JAX lane's done = ~isfinite(cost0)); the options' defaults are the
    JAX ones."""
    assert ctt.TinySolverOptions() == ctt.TinySolverOptions(
        **{f: getattr(ct.TinySolverOptions(), f) for f in
           ("max_num_iterations", "gradient_tolerance", "parameter_tolerance",
            "cost_threshold", "initial_trust_region_radius")})
    x0 = np.array([[-1.2, 1.0], [np.nan, 1.0]])
    solver = ctt.TinySolver(_rosenbrock_t, ctt.TinySolverOptions(max_num_iterations=5),
                            device="cpu")
    x, s = solver.solve_batch(x0, None)
    xj, sj = ct.TinySolver(_rosenbrock_j, ct.TinySolverOptions(max_num_iterations=5)
                           ).solve_batch(jnp.asarray(x0), None)
    np.testing.assert_array_equal(s.iterations.numpy(), np.asarray(sj.iterations))
    assert int(s.iterations[1]) == 0 and np.isnan(x[1, 0].item())
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj)[0], rtol=0, atol=1e-12)


def test_tiny_solver_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ctt.TinySolver(_rosenbrock_t)
