"""Rotation representation conversions on torch tensors.

PyTorch counterpart of gesturediffusion_tpu/ops/rotations.py: quaternion,
matrix, axis-angle, Euler and 6D conversions in the same closed forms, on
any leading batch dims.  Every function is differentiable; the geometric
training losses backpropagate through ``rotation_6d_to_matrix``.

Conventions: quaternions are (w, x, y, z), real part first; matrices act
on column vectors (p' = R @ p); the 6D representation is a matrix's first
two rows, decoded by Gram-Schmidt (Zhou et al., CVPR'19).
"""

from __future__ import annotations

from typing import Optional

import torch


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) -> rotation matrices (..., 3, 3)
    (rotations.py:22)."""
    r, i, j, k = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x))."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) with w >= 0
    (rotations.py:52: Shepperd's closed form, the signs from the
    off-diagonal differences)."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    w = 0.5 * _sqrt_positive_part(1.0 + m00 + m11 + m22)
    x = 0.5 * _sqrt_positive_part(1.0 + m00 - m11 - m22)
    y = 0.5 * _sqrt_positive_part(1.0 - m00 + m11 - m22)
    z = 0.5 * _sqrt_positive_part(1.0 - m00 - m11 + m22)
    x = torch.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = torch.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = torch.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([w, x, y, z], dim=-1)


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Non-negative real part (q and -q are the same rotation)."""
    return torch.where(quaternions[..., :1] < 0, -quaternions, quaternions)


def quaternion_raw_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions (..., 4)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product with a non-negative real part."""
    return standardize_quaternion(quaternion_raw_multiply(a, b))


def quaternion_invert(quaternion: torch.Tensor) -> torch.Tensor:
    """Inverse (conjugate) of unit quaternions."""
    return quaternion * quaternion.new_tensor([1.0, -1.0, -1.0, -1.0])


def quaternion_apply(quaternion: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate points (..., 3) by unit quaternions (..., 4)."""
    point_as_quaternion = torch.cat([torch.zeros_like(point[..., :1]), point], dim=-1)
    out = quaternion_raw_multiply(
        quaternion_raw_multiply(quaternion, point_as_quaternion),
        quaternion_invert(quaternion),
    )
    return out[..., 1:]


def _sin_half_over_angle(angles: torch.Tensor) -> torch.Tensor:
    """sin(x/2)/x, by its Taylor expansion 1/2 - x^2/48 below 1e-6."""
    small = angles.abs() < 1e-6
    return torch.where(
        small,
        0.5 - (angles * angles) / 48.0,
        torch.sin(angles * 0.5) / torch.where(small, torch.ones_like(angles), angles),
    )


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> quaternions (..., 4) (rotations.py:111).
    The norm's square is clamped at 1e-24, so the zero rotation has a zero
    gradient, not NaN."""
    sq = (axis_angle * axis_angle).sum(-1, keepdim=True)
    angles = torch.sqrt(torch.clamp(sq, min=1e-24))
    return torch.cat(
        [torch.cos(angles * 0.5), axis_angle * _sin_half_over_angle(angles)], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) -> axis-angle vectors (..., 3)."""
    norms = torch.linalg.vector_norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    return quaternions[..., 1:] / _sin_half_over_angle(2.0 * half_angles)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3) (rotations.py:153)."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6D representation (..., 6) -> rotation matrices (..., 3, 3), by
    Gram-Schmidt on the two encoded rows (rotations.py:166)."""

    def safe_normalize(v):
        # the squared norm clamped at 1e-12: a degenerate (near-zero) input
        # stays finite, with the reference's gradient (F.normalize clamps
        # the norm instead, and differentiates otherwise)
        sq = (v * v).sum(-1, keepdim=True)
        return v / torch.sqrt(torch.clamp(sq, min=1e-12))

    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = safe_normalize(a1)
    b2 = safe_normalize(a2 - (b1 * a2).sum(-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> 6D representation (..., 6): the
    first two rows (rotations.py:186)."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


_EULER_AXES = {"X": 0, "Y": 1, "Z": 2}


def _axis_angle_rotation(axis: str, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrices about a principal axis."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == "Y":
        flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    elif axis == "Z":
        flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in _EULER_AXES for c in convention):
        raise ValueError(f"invalid convention {convention}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3); ``convention``
    is three letters of X, Y, Z (intrinsic rotations)."""
    _check_convention(convention)
    m = [_axis_angle_rotation(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return m[0] @ m[1] @ m[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool,
                    tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i2, i1 = i1, i2
    even = (axis + other_axis) in {"XY", "YZ", "ZX"}
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3)."""
    _check_convention(convention)
    i0 = _EULER_AXES[convention[0]]
    i2 = _EULER_AXES[convention[2]]
    tait_bryan = i0 != i2
    if tait_bryan:
        central_angle = torch.asin(torch.clamp(
            matrix[..., i0, i2] * (-1.0 if i0 - i2 in [-1, 2] else 1.0), -1, 1))
    else:
        central_angle = torch.acos(torch.clamp(matrix[..., i0, i0], -1, 1))
    o = (
        _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan),
        central_angle,
        _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan),
    )
    return torch.stack(o, dim=-1)


def random_quaternions(n: int, generator: Optional[torch.Generator] = None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniformly distributed unit quaternions (n, 4), drawn from
    ``generator``."""
    o = torch.randn((n, 4), generator=generator, dtype=dtype, device=device)
    return o / torch.linalg.vector_norm(o, dim=-1, keepdim=True)


def random_rotations(n: int, generator: Optional[torch.Generator] = None,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniformly distributed rotation matrices (n, 3, 3)."""
    return quaternion_to_matrix(random_quaternions(n, generator, dtype, device))
