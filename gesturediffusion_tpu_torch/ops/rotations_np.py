"""Rotation conversions in numpy for the data side.

Copy of gesturediffusion_tpu/ops/rotations_np.py: the same closed forms as
ops/rotations.py, kept in numpy so that data loading works on the host
arrays the datasets hold.  Quaternions are (w, x, y, z); matrices act on
column vectors; the 6D representation is a matrix's first two rows.
"""

from __future__ import annotations

import numpy as np


def axis_angle_to_quaternion_np(axis_angle: np.ndarray) -> np.ndarray:
    angles = np.linalg.norm(axis_angle, axis=-1, keepdims=True)
    half = angles * 0.5
    small = np.abs(angles) < 1e-6
    # sin(x/2)/x ~ 1/2 - x^2/48 near zero
    sin_half_over_angle = np.where(
        small, 0.5 - angles * angles / 48.0,
        np.sin(half) / np.where(small, 1.0, angles),
    )
    return np.concatenate([np.cos(half), axis_angle * sin_half_over_angle], -1)


def quaternion_to_matrix_np(q: np.ndarray) -> np.ndarray:
    r, i, j, k = (q[..., n] for n in range(4))
    two_s = 2.0 / np.sum(q * q, axis=-1)
    o = np.stack(
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
        axis=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_matrix_np(axis_angle: np.ndarray) -> np.ndarray:
    return quaternion_to_matrix_np(axis_angle_to_quaternion_np(axis_angle))


def matrix_to_rotation_6d_np(matrix: np.ndarray) -> np.ndarray:
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def matrix_to_quaternion_np(matrix: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> quaternions (..., 4) with w >= 0
    (Shepperd's closed form, the signs from the off-diagonal differences)."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]

    def sqrt_pos(x):
        return np.sqrt(np.maximum(x, 0.0))

    w = 0.5 * sqrt_pos(1.0 + m00 + m11 + m22)
    x = 0.5 * sqrt_pos(1.0 + m00 - m11 - m22)
    y = 0.5 * sqrt_pos(1.0 - m00 + m11 - m22)
    z = 0.5 * sqrt_pos(1.0 - m00 - m11 + m22)
    x = np.copysign(x, m[..., 2, 1] - m[..., 1, 2])
    y = np.copysign(y, m[..., 0, 2] - m[..., 2, 0])
    z = np.copysign(z, m[..., 1, 0] - m[..., 0, 1])
    return np.stack([w, x, y, z], axis=-1)


def quaternion_to_axis_angle_np(q: np.ndarray) -> np.ndarray:
    """Quaternions (..., 4) -> axis-angle vectors (..., 3)."""
    norms = np.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    half_angles = np.arctan2(norms, q[..., :1])
    angles = 2.0 * half_angles
    small = np.abs(angles) < 1e-6
    sin_half_over_angle = np.where(
        small, 0.5 - (angles * angles) / 48.0,
        np.sin(half_angles) / np.where(small, 1.0, angles),
    )
    return q[..., 1:] / sin_half_over_angle


def matrix_to_axis_angle_np(matrix: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3)."""
    return quaternion_to_axis_angle_np(matrix_to_quaternion_np(matrix))
