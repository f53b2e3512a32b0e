"""Quaternion helpers in numpy for the data side.

Copy of gesturediffusion_tpu/ops/quaternion_np.py (the numpy twins of
ops/quaternion.py).  Quaternions are (w, x, y, z), real part first.
"""

from __future__ import annotations

import numpy as np

from gesturediffusion_tpu_torch.ops.rotations_np import quaternion_to_matrix_np


def qinv_np(q: np.ndarray) -> np.ndarray:
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def qmul_np(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    qw, qx, qy, qz = (q[..., n] for n in range(4))
    rw, rx, ry, rz = (r[..., n] for n in range(4))
    return np.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        axis=-1,
    )


def qrot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    qvec = q[..., 1:]
    uv = np.cross(qvec, v)
    uuv = np.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qbetween_np(v0: np.ndarray, v1: np.ndarray) -> np.ndarray:
    v = np.cross(v0, v1)
    w = np.sqrt(
        (v0**2).sum(-1, keepdims=True) * (v1**2).sum(-1, keepdims=True)
    ) + (v0 * v1).sum(-1, keepdims=True)
    q = np.concatenate([w, v], axis=-1)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def qfix_np(q: np.ndarray) -> np.ndarray:
    """Sign continuity along axis 0 of (T, J, 4)."""
    result = q.copy()
    dots = np.sum(q[1:] * q[:-1], axis=-1)
    flip = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    result[1:][flip] *= -1
    return result


def quaternion_to_cont6d_np(q: np.ndarray) -> np.ndarray:
    m = quaternion_to_matrix_np(q)
    return np.concatenate([m[..., 0], m[..., 1]], axis=-1)
