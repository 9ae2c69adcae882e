"""ceres_tpu_torch.capi and ceres_tpu_torch.utils.profiling against their
JAX twins (tests/test_misc_components.py's test_capi_surface and
test_execution_summary_and_event_logger), on the CPU."""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu import capi as jcapi
from ceres_tpu.utils import profiling as jprof

from ceres_tpu_torch import capi
from ceres_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401


def _capi_run(mod, residual, loss, numeric, device=None):
    p = mod.ceres_create_problem()
    x = np.zeros(2)
    rid = mod.ceres_problem_add_residual_block(
        p, residual, 2, [2], [x], loss_function_name=loss, loss_function_parameter=1.0,
        use_numeric_diff=numeric)
    kw = {} if device is None else {"device": device}
    s = mod.ceres_solve(p, max_num_iterations=20, **kw)
    return p, x, rid, s


@pytest.mark.parametrize("loss,numeric", [("huber", False), ("cauchy", True), (None, False)])
def test_capi_surface_matches_jax(loss, numeric):
    """The capi surface on the same residual: the solution, final cost and
    rows of the JAX capi's, then ceres_free_problem empties the problem."""
    p, x, rid, s = _capi_run(
        capi, lambda v: v - torch.tensor([1.0, 2.0], dtype=v.dtype, device=v.device),
        loss, numeric, device="cpu")
    _, xj, _, sj = _capi_run(jcapi, lambda v: v - jnp.asarray([1.0, 2.0]), loss, numeric)
    assert isinstance(rid, int)
    assert s.is_solution_usable()
    np.testing.assert_allclose(x, [1.0, 2.0], atol=1e-6)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-12)
    assert abs(s.final_cost - sj.final_cost) <= 1e-12
    assert len(s.iterations) == len(sj.iterations)
    capi.ceres_free_problem(p)
    assert p.num_residual_blocks() == 0


def test_capi_losses_match_jax():
    """The (name, parameter) loss table names the same losses, each rho
    (and its derivatives) at s = 0.3, 2 and 7 that of the JAX loss."""
    assert sorted(capi._LOSSES) == sorted(jcapi._LOSSES)
    s = np.array([0.3, 2.0, 7.0])
    for name in capi._LOSSES:
        out = capi._LOSSES[name](1.5).evaluate(torch.as_tensor(s))
        ref = jcapi._LOSSES[name](1.5).evaluate(jnp.asarray(s))
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)


def test_capi_solve_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = capi.ceres_create_problem()
    capi.ceres_problem_add_residual_block(p, lambda v: v, 2, [2], [np.ones(2)])
    with pytest.raises(RuntimeError):
        capi.ceres_solve(p)


def test_execution_summary_and_event_logger_match_jax(caplog):
    """The twin of test_execution_summary_and_event_logger: the same calls
    counted, the same report but for the times, events logged under the
    port's logger name."""
    reports = []
    for mod in (profiling, jprof):
        es = mod.ExecutionSummary()
        for name in ("foo", "foo", "bar"):
            with es.scoped_timer(name):
                pass
        assert es.num_calls("foo") == 2 and es.num_calls("bar") == 1
        assert es.total_time("foo") >= 0.0
        reports.append([line.split()[:2] for line in es.report().splitlines()])
    assert reports[0] == reports[1]
    with caplog.at_level(logging.DEBUG, logger="ceres_tpu_torch"):
        el = profiling.EventLogger("test")
        el.add_event("phase1")
        el.add_event("phase2")
    assert [e for e, _, _ in el.events] == ["phase1", "phase2"]
    assert all(d >= 0.0 and t >= d for _, d, t in el.events)
    assert [r.name for r in caplog.records] == ["ceres_tpu_torch"] * 2
    assert "phase2" in caplog.records[1].getMessage()


def test_scoped_timer_counts_a_raising_call():
    es = profiling.ExecutionSummary()
    with pytest.raises(ValueError):
        with es.scoped_timer("bad"):
            raise ValueError
    assert es.num_calls("bad") == 1
