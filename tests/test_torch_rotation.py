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


# -- the five functions of port slice 18 (tests/test_rotation.py:41-150) --------


def _np(t):
    return np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.float64)


@pytest.mark.parametrize("name", ["angle_axis_to_rotation_matrix", "cross_product_matrix",
                                  "euler_angles_to_rotation_matrix"])
def test_slice18_rotations_match_jax(name):
    """Batched and on single vectors, zero and sub-eps angles included, to
    1e-12 of the JAX functions (1e-12 of the largest |value|)."""
    aa, _, _ = _inputs(4)
    arg = aa * 57.0 if name == "euler_angles_to_rotation_matrix" else aa
    out, ref = _both(name, arg)
    _close(out, ref, 1e-12)
    for i in (0, 1, 5):
        out1, ref1 = _both(name, arg[i])
        _close(out1, ref1, 1e-12)


def test_angle_axis_rotation_matrix_round_trip_and_orthonormal():
    """The twins of test_angle_axis_rotation_matrix_round_trip,
    test_rotation_matrices_are_orthonormal and test_rotate_point_consistency."""
    rng = np.random.default_rng(1)
    axis = rng.standard_normal((50, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    aa = axis * rng.uniform(-np.pi + 1e-3, np.pi - 1e-3, (50, 1))
    R = tr.angle_axis_to_rotation_matrix(torch.as_tensor(aa))
    _close(tr.rotation_matrix_to_angle_axis(R), aa, 1e-10)
    Rn = R.numpy()
    _close(Rn @ Rn.transpose(0, 2, 1), np.broadcast_to(np.eye(3), Rn.shape), 1e-12)
    _close(np.linalg.det(Rn), np.ones(50), 1e-12)
    pts = rng.standard_normal((50, 3))
    _close(np.einsum("bij,bj->bi", Rn, pts),
           tr.angle_axis_rotate_point(torch.as_tensor(aa), torch.as_tensor(pts)), 1e-12)
    _close(tr.cross_product_matrix(torch.as_tensor(aa)).numpy() @ pts[:, :, None],
           np.cross(aa, pts)[:, :, None], 1e-12)


def test_euler_angles_degrees_orthonormal():
    e = np.asarray([[10.0, 20.0, 30.0], [0.0, 0.0, 0.0]])
    R = tr.euler_angles_to_rotation_matrix(torch.as_tensor(e)).numpy()
    _close(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), 1e-12)
    _close(R[1], np.eye(3), 1e-12)


@pytest.mark.parametrize("conv", list(jr.EULER_CONVENTIONS))
def test_generalized_euler_matches_jax(conv):
    """Each of the 24 conventions: the matrix and the angles back from it
    against the JAX functions (1e-12), and the round trip with the
    mid-angle inside its branch's principal range (1e-10), as
    test_generalized_euler_round_trip_all_24_conventions."""
    assert tr.EULER_CONVENTIONS == jr.EULER_CONVENTIONS
    rng = np.random.default_rng(abs(hash(conv)) % 1000)
    for _ in range(3):
        t = rng.uniform(-1.2, 1.2, 3)
        if conv[-3] == conv[-1]:
            t[1] = rng.uniform(0.1, 2.9)  # the arccos branch: (0, pi)
        R = tr.euler_angles_to_rotation(conv, torch.as_tensor(t))
        _close(R, jr.euler_angles_to_rotation(conv, jnp.asarray(t)), 1e-12)
        back = tr.rotation_matrix_to_euler_angles(conv, R)
        _close(back, jr.rotation_matrix_to_euler_angles(conv, jnp.asarray(R.numpy())), 1e-12)
        _close(back, t, 1e-10)
    with pytest.raises(ValueError):
        tr.euler_angles_to_rotation(conv.replace("trinsic", "trinsik"), torch.zeros(3))


def test_generalized_euler_explicit_composition():
    """IntrinsicZYX(t) == ExtrinsicXYZ(t reversed), and numpy arrays are
    taken as they are."""
    t = np.random.default_rng(1).uniform(-1.0, 1.0, 3)
    Ri = tr.euler_angles_to_rotation("IntrinsicZYX", t)
    Re = tr.euler_angles_to_rotation("ExtrinsicXYZ", t[::-1].copy())
    _close(Ri, Re, 1e-12)
    with pytest.raises(ValueError):
        tr.euler_angles_to_rotation("IntrinsicZZY", t)


@pytest.mark.parametrize("name", ["angle_axis_to_rotation_matrix", "cross_product_matrix",
                                  "euler_angles_to_rotation_matrix", "euler_angles_to_rotation",
                                  "rotation_matrix_to_euler_angles"])
def test_slice18_rotations_differentiable_at_zero(name):
    """torch.func.jacfwd at zero angles (the identity for the inverse) is
    finite and equals jax.jacfwd's."""
    if name == "euler_angles_to_rotation":
        tf = lambda v: tr.euler_angles_to_rotation("IntrinsicZYX", v)  # noqa: E731
        jf = lambda v: jr.euler_angles_to_rotation("IntrinsicZYX", v)  # noqa: E731
        arg = np.zeros(3)
    elif name == "rotation_matrix_to_euler_angles":
        tf = lambda R: tr.rotation_matrix_to_euler_angles("ExtrinsicXYZ", R)  # noqa: E731
        jf = lambda R: jr.rotation_matrix_to_euler_angles("ExtrinsicXYZ", R)  # noqa: E731
        arg = np.eye(3)
    else:
        tf, jf, arg = getattr(tr, name), getattr(jr, name), np.zeros(3)
    out = torch.func.jacfwd(tf)(torch.as_tensor(arg))
    ref = jax.jacfwd(jf)(jnp.asarray(arg))
    assert bool(torch.isfinite(out).all())
    _close(out, ref, 1e-12)


def test_slice18_rotations_batch_under_vmap():
    """euler_angles_to_rotation under torch.func.vmap (how chip_smoke.py
    batches it) agrees with the one-at-a-time calls to 1e-14 (a batched
    matrix product may round its sums apart from a single one)."""
    rng = np.random.default_rng(5)
    t = torch.as_tensor(rng.uniform(-1.0, 1.0, (7, 3)))
    R = torch.func.vmap(lambda v: tr.euler_angles_to_rotation("IntrinsicXYX", v))(t)
    for i in range(7):
        _close(R[i], tr.euler_angles_to_rotation("IntrinsicXYX", t[i]), 1e-14)
    back = torch.func.vmap(lambda M: tr.rotation_matrix_to_euler_angles("IntrinsicXYX", M))(R)
    for i in range(7):
        _close(back[i], tr.rotation_matrix_to_euler_angles("IntrinsicXYX", R[i]), 1e-14)
