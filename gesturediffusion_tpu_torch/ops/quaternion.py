"""Quaternion toolbox of the HumanML3D motion codec and the skeleton.

PyTorch counterpart of gesturediffusion_tpu/ops/quaternion.py (:20-200):
``qinv``, ``qnormalize``, ``qmul``, ``qrot``, ``qeuler``, ``qfix``,
``euler_to_quaternion``, ``expmap_to_quaternion``, ``quaternion_to_matrix``,
``quaternion_to_cont6d``, ``cont6d_to_matrix``, ``qpow``, ``qslerp``,
``qbetween`` and ``lerp``.  Quaternions are (w, x, y, z), real part first;
shapes broadcast over the leading dims.  The cont6d representation here
stacks the first two *columns* of the rotation matrix (ops/rotations.py's
``matrix_to_rotation_6d`` takes rows: both conventions are the
reference's).
"""

from __future__ import annotations

import math

import torch

from gesturediffusion_tpu_torch.ops import rotations


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternions (..., 4)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def qnormalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q * r of quaternions (..., 4)."""
    aw, ax, ay, az = q.unbind(-1)
    bw, bx, by, bz = r.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4); shapes broadcast."""
    qvec, v = torch.broadcast_tensors(q[..., 1:], v)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


# order -> the three angles over (q0, q1, q2, q3); a tuple ("asin", arg)
# marks the angle taken with a clipped arcsine
_QEULER_FORMULAS = {
    "xyz": (
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2)),
        lambda q0, q1, q2, q3: ("asin", 2 * (q1 * q3 + q0 * q2)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3)),
    ),
    "yzx": (
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3)),
        lambda q0, q1, q2, q3: ("asin", 2 * (q1 * q2 + q0 * q3)),
    ),
    "zxy": (
        lambda q0, q1, q2, q3: ("asin", 2 * (q0 * q1 + q2 * q3)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3)),
    ),
    "xzy": (
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3)),
        lambda q0, q1, q2, q3: ("asin", 2 * (q0 * q3 - q1 * q2)),
    ),
    "yxz": (
        lambda q0, q1, q2, q3: ("asin", 2 * (q0 * q1 - q2 * q3)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3)),
    ),
    "zyx": (
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2)),
        lambda q0, q1, q2, q3: ("asin", 2 * (q0 * q2 - q1 * q3)),
        lambda q0, q1, q2, q3: torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3)),
    ),
}


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0, deg: bool = True) -> torch.Tensor:
    """Quaternions (..., 4) -> Euler angles (..., 3) in the given axis order."""
    if order not in _QEULER_FORMULAS:
        raise ValueError(f"unsupported euler order {order}")
    q0, q1, q2, q3 = q.unbind(-1)
    comps = []
    for f in _QEULER_FORMULAS[order]:
        val = f(q0, q1, q2, q3)
        if isinstance(val, tuple):
            val = torch.asin(torch.clamp(val[1], -1 + epsilon, 1 - epsilon))
        comps.append(val)
    out = torch.stack(comps, dim=-1)
    return out * (180.0 / math.pi) if deg else out


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the time axis of a (T, J, 4) sequence: q or -q
    a frame, so that consecutive quaternions have a non-negative dot."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)
    flip = torch.cumsum((dots < 0).to(torch.int64), dim=0) % 2 == 1
    sign = torch.where(flip, -1.0, 1.0).to(q.dtype)[..., None]
    return torch.cat([q[:1], q[1:] * sign], dim=0)


def euler_to_quaternion(e: torch.Tensor, order: str, deg: bool = False) -> torch.Tensor:
    """Euler angles (..., 3) -> quaternions (..., 4), intrinsic composition,
    with the reference's antipodal sign for the right-handed orders."""
    if deg:
        e = e * (math.pi / 180.0)
    x, y, z = e.unbind(-1)
    zeros = torch.zeros_like(x)
    table = {
        "x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros], dim=-1),
        "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros], dim=-1),
        "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)], dim=-1),
    }
    result = None
    for coord in order:
        r = table[coord]
        result = r if result is None else qmul(result, r)
    if order in ("xyz", "yzx", "zxy"):
        result = -result
    return result


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle / exponential map (..., 3) -> quaternions (..., 4)."""
    theta = torch.linalg.norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([w, xyz], dim=-1)


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) -> matrices (..., 3, 3)."""
    return rotations.quaternion_to_matrix(quaternions)


def quaternion_to_cont6d(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternions -> 6D rep = the first two matrix *columns* concatenated."""
    m = quaternion_to_matrix(quaternions)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(cont6d: torch.Tensor) -> torch.Tensor:
    """Column-convention 6D rep (..., 6) -> rotation matrices (..., 3, 3)."""
    x_raw, y_raw = cont6d[..., 0:3], cont6d[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def qpow(q0: torch.Tensor, t, eps: float = 1e-9) -> torch.Tensor:
    """Unit quaternions raised to the power(s) t; output t.shape + q0.shape."""
    q0 = qnormalize(q0)
    theta0 = torch.acos(torch.clamp(q0[..., 0], -1.0, 1.0))
    theta0 = torch.where(torch.abs(theta0) <= eps, torch.full_like(theta0, eps), theta0)
    v0 = q0[..., 1:] / torch.sin(theta0)[..., None]
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    theta = t.reshape(t.shape + (1,) * theta0.ndim) * theta0
    w = torch.cos(theta)[..., None]
    xyz = v0.expand(theta.shape + (3,)) * torch.sin(theta)[..., None]
    return torch.cat([w, xyz], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation from q0 to q1 at points t; output
    t.shape + q0.shape."""
    q0 = qnormalize(q0)
    q1 = qnormalize(q1)
    q_ = qpow(qmul(q1, qinv(q0)), t)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    return qmul(q_, q0.expand(t.shape + q0.shape))


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """The quaternion that rotates v0 onto v1 (both (..., 3))."""
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt(torch.sum(v0 * v0, dim=-1, keepdim=True)
                   * torch.sum(v1 * v1, dim=-1, keepdim=True)) \
        + torch.sum(v0 * v1, dim=-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)
    return p0 + t.reshape(t.shape + (1,) * p0.ndim) * (p1 - p0)
