"""The angle-axis model's jt evaluation with a robust loss in float32
against the JAX package's eval_fused kernel in interpret mode: cost to
1e-5 and gradient to 1e-4 (tests/test_torch_robust_quat.py holds the
quaternion model to the same; the two files split the interpret-mode
compiles, ~30 s each, between test workers)."""
import pytest

from test_torch_robust_quat import LOSSES, check_interpret


@pytest.mark.parametrize("loss_name", LOSSES)
def test_angle_axis_jt_evaluation_f32_matches_interpret_kernel(loss_name):
    check_interpret("angle_axis", loss_name)
