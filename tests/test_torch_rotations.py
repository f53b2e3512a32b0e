"""Port parity of the rotation conversions against the JAX package on the
CPU: the numpy copies (ops/rotations_np.py, ops/quaternion_np.py) equal
JAX's exactly, and the torch conversions (ops/rotations.py) agree with
gesturediffusion_tpu/ops/rotations.py at rtol 1e-5 / atol 1e-6 (float32,
the same closed forms), the gradients of rotation_6d_to_matrix included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesturediffusion_tpu.ops import quaternion_np as jqn
from gesturediffusion_tpu.ops import rotations as jr
from gesturediffusion_tpu.ops import rotations_np as jrn
from gesturediffusion_tpu_torch.ops import quaternion_np as pqn
from gesturediffusion_tpu_torch.ops import rotations as pr
from gesturediffusion_tpu_torch.ops import rotations_np as prn

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    aa = rs.randn(5, 7, 3) * 1.5
    aa[0, 0] = 0.0            # the zero rotation
    aa[0, 1] = 1e-8           # below the Taylor switch
    q = rs.randn(5, 7, 4)
    m = jrn.axis_angle_to_matrix_np(aa)
    return aa, q, m


def test_numpy_copies_equal_jax_exactly():
    aa, q, m = _inputs()
    v0, v1 = np.random.RandomState(1).randn(2, 6, 3)
    for name in ("axis_angle_to_quaternion_np", "axis_angle_to_matrix_np",
                 "quaternion_to_matrix_np", "matrix_to_quaternion_np",
                 "quaternion_to_axis_angle_np", "matrix_to_axis_angle_np",
                 "matrix_to_rotation_6d_np"):
        arg = {"axis": aa, "quat": q, "matr": m}[name.split("_")[0][:4]]
        np.testing.assert_array_equal(getattr(prn, name)(arg), getattr(jrn, name)(arg), name)
    np.testing.assert_array_equal(pqn.qinv_np(q), jqn.qinv_np(q))
    np.testing.assert_array_equal(pqn.qmul_np(q, q[::-1]), jqn.qmul_np(q, q[::-1]))
    np.testing.assert_array_equal(pqn.qrot_np(q[0, :6], v0), jqn.qrot_np(q[0, :6], v0))
    np.testing.assert_array_equal(pqn.qbetween_np(v0, v1), jqn.qbetween_np(v0, v1))
    np.testing.assert_array_equal(pqn.qfix_np(q), jqn.qfix_np(q))
    np.testing.assert_array_equal(pqn.quaternion_to_cont6d_np(q), jqn.quaternion_to_cont6d_np(q))


def _both(name, *args, **kw):
    got = getattr(pr, name)(*(torch.from_numpy(np.float32(a)) for a in args), **kw)
    want = getattr(jr, name)(*(jnp.asarray(np.float32(a)) for a in args), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name,arg", [
    ("quaternion_to_matrix", "q"), ("matrix_to_quaternion", "m"),
    ("standardize_quaternion", "q"), ("quaternion_invert", "q"),
    ("axis_angle_to_quaternion", "aa"), ("quaternion_to_axis_angle", "q"),
    ("axis_angle_to_matrix", "aa"), ("matrix_to_axis_angle", "m"),
    ("rotation_6d_to_matrix", "d6"), ("matrix_to_rotation_6d", "m"),
])
def test_conversions_match_jax(name, arg):
    aa, q, m = _inputs()
    d6 = np.random.RandomState(2).randn(5, 7, 6)
    d6[0, 0] = 0.0  # degenerate: finite through the clamped norm
    x = {"aa": aa, "q": q, "m": m, "d6": d6}[arg]
    got, want = _both(name, x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_products_apply_and_euler_match_jax():
    _, q, _ = _inputs()
    p = np.random.RandomState(3).randn(5, 7, 3)
    for name, args in (("quaternion_raw_multiply", (q, q[::-1])),
                       ("quaternion_multiply", (q, q[::-1])),
                       ("quaternion_apply", (q / np.linalg.norm(q, axis=-1, keepdims=True), p))):
        got, want = _both(name, *args)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    angles = np.random.RandomState(4).uniform(-1.4, 1.4, (9, 3))
    for conv in ("XYZ", "ZYX", "YXZ", "XYX", "ZXZ"):
        got, want = _both("euler_angles_to_matrix", angles, convention=conv)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=conv)
        got, want = _both("matrix_to_euler_angles", got, convention=conv)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=conv)
    with pytest.raises(ValueError):
        pr.euler_angles_to_matrix(torch.zeros(3), "XYW")


def test_rotation_6d_gradients_match_jax():
    """d/d6 of a weighted sum of the decoded matrices, through the clamped
    normalisation (a degenerate row included)."""
    rs = np.random.RandomState(5)
    d6 = rs.randn(4, 6, 6).astype(np.float32)
    d6[0, 0] = 0.0
    w = rs.randn(4, 6, 3, 3).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jr.rotation_6d_to_matrix(x) * w))(
        jnp.asarray(d6)))
    x = torch.from_numpy(d6).requires_grad_()
    (pr.rotation_6d_to_matrix(x) * torch.from_numpy(w)).sum().backward()
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=ATOL)


def test_random_rotations_are_rotations():
    m = pr.random_rotations(64, torch.Generator().manual_seed(0))
    eye = torch.eye(3).expand(64, 3, 3)
    torch.testing.assert_close(m @ m.transpose(-1, -2), eye, rtol=0, atol=1e-5)
    torch.testing.assert_close(torch.linalg.det(m), torch.ones(64), rtol=0, atol=1e-5)
