"""ceres_tpu_torch.rotation against ceres_tpu.rotation (the twin of the
rotations of tests/test_rotation.py that the port carries), on the same
numpy inputs to 1e-13, batched and on single vectors, with the small-angle
branches and their derivatives."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu import rotation as jr

from ceres_tpu_torch import rotation as tr

TOL = 1e-13


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _inputs(seed=0, n=12):
    rng = np.random.default_rng(seed)
    aa = rng.standard_normal((n, 3))
    aa[0] = 0.0
    aa[1] = 1e-9 * rng.standard_normal(3)  # below the small-angle threshold
    aa[2] *= 3.0  # past pi
    q = rng.standard_normal((n, 4))
    q[-1] = [-0.2, 0.5, 0.1, -0.8]  # w < 0
    pts = rng.standard_normal((n, 3)) * 2.0
    return aa, q, pts


def _both(name, *args):
    out = getattr(tr, name)(*(torch.as_tensor(a) for a in args))
    ref = getattr(jr, name)(*(jnp.asarray(a) for a in args))
    return out, ref


@pytest.mark.parametrize("name", [
    "angle_axis_to_quaternion", "quaternion_conjugate", "quaternion_to_angle_axis",
    "quaternion_to_rotation_matrix", "rotation_matrix_to_quaternion",
    "rotation_matrix_to_angle_axis"])
def test_one_argument_rotations_match_jax(name):
    aa, q, _ = _inputs()
    if name == "angle_axis_to_quaternion":
        arg = aa
    elif name.startswith("rotation_matrix"):
        arg = np.array(jr.angle_axis_to_rotation_matrix(jnp.asarray(aa)))
    elif name == "quaternion_to_angle_axis":
        arg = q / np.linalg.norm(q, axis=1, keepdims=True)
    else:
        arg = q
    out, ref = _both(name, arg)
    _close(out, ref)
    # one vector at a time too
    out1, ref1 = _both(name, arg[3])
    _close(out1, ref1)


def test_unit_quaternion_to_rotation_matrix_matches_jax():
    _, q, _ = _inputs(1)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    out, ref = _both("unit_quaternion_to_rotation_matrix", q)
    _close(out, ref)
    R = out.numpy()
    _close(np.einsum("nij,nkj->nik", R, R), np.broadcast_to(np.eye(3), R.shape))


@pytest.mark.parametrize("name", ["quaternion_product", "unit_quaternion_rotate_point",
                                  "quaternion_rotate_point", "angle_axis_rotate_point"])
def test_two_argument_rotations_match_jax(name):
    aa, q, pts = _inputs(2)
    if name == "quaternion_product":
        args = (q, q[::-1].copy())
    elif name == "unit_quaternion_rotate_point":
        args = (q / np.linalg.norm(q, axis=1, keepdims=True), pts)
    elif name == "quaternion_rotate_point":
        args = (q, pts)
    else:
        args = (aa, pts)
    out, ref = _both(name, *args)
    _close(out, ref)


def test_quaternion_and_angle_axis_rotate_alike():
    """The quaternion of an angle-axis rotates a point as the angle-axis
    does, and maps back to it."""
    aa, _, pts = _inputs(3)
    aa = aa[3:]  # away from zero and below pi
    aa = aa / np.linalg.norm(aa, axis=1, keepdims=True) * 0.7
    q = tr.angle_axis_to_quaternion(torch.as_tensor(aa))
    torch.testing.assert_close(tr.unit_quaternion_rotate_point(q, torch.as_tensor(pts[3:])),
                               tr.angle_axis_rotate_point(torch.as_tensor(aa),
                                                          torch.as_tensor(pts[3:])),
                               rtol=0, atol=1e-13)
    torch.testing.assert_close(tr.quaternion_to_angle_axis(q), torch.as_tensor(aa),
                               rtol=0, atol=1e-13)


def test_angle_axis_to_quaternion_derivative_at_zero_matches_jax():
    """The small-angle branch keeps the Jacobian finite at zero: 0.5 I
    below the first row."""
    z = np.zeros(3)
    out = torch.func.jacfwd(tr.angle_axis_to_quaternion)(torch.as_tensor(z))
    ref = jax.jacfwd(jr.angle_axis_to_quaternion)(jnp.asarray(z))
    _close(out, ref)
    assert bool(torch.isfinite(out).all())
