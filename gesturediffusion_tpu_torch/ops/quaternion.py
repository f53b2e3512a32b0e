"""Quaternion helpers of the HumanML3D motion codec.

PyTorch counterpart of the part of gesturediffusion_tpu/ops/quaternion.py
that ops/motion_process.py:recover_from_ric needs: ``qinv`` (:20),
``qmul`` (:32) and ``qrot`` (:40).  Quaternions are (w, x, y, z), real
part first; shapes broadcast over the leading dims.  The rest of that
file (Euler angles, cont6d, slerp) waits for the geometry slice.
"""

from __future__ import annotations

import torch


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternions (..., 4)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


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
