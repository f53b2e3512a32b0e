"""The HumanML3D motion codec back to joint positions.

PyTorch counterpart of gesturediffusion_tpu/ops/motion_process.py
(``recover_root_rot_pos`` :32, ``recover_from_ric`` :68,
``recover_from_rot`` :83, ``recover_rot`` :96).  The feature
layout of a frame, for J joints (263 = 12 * 22 - 1 for HumanML3D, 251 for
KIT's 21 joints):

    [0]                      root rotation (yaw) velocity
    [1:3]                    root linear velocity (x, z)
    [3]                      root height y
    [4 : 4+(J-1)*3]          rotation-invariant joint positions (RIC)
    [... : ...+(J-1)*6]      joint rotations (cont6d)
    [... : ...+J*3]          local joint velocities
    [-4:]                    foot contact labels

``recover_from_ric`` reads the root and RIC parts, ``recover_from_rot``
and ``recover_rot`` the root and rotation parts.  The velocities are
integrated with a shifted cumulative sum, so frame i depends on frames
before it alone.  The forward codec is ops/motion_features.py.
"""

from __future__ import annotations

import torch

from gesturediffusion_tpu_torch.ops.quaternion import qinv, qrot, quaternion_to_cont6d


def joints_of_features(n_features: int) -> int:
    """J of the codec: 12 * J - 1 features (263 -> 22, 251 -> 21)."""
    return (n_features + 1) // 12


def recover_root_rot_pos(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Root yaw quaternion and root position from the velocity features.
    data [..., T, D] -> (r_rot_quat [..., T, 4], r_pos [..., T, 3])."""
    rot_vel = data[..., 0]
    # the yaw velocity integrated, shifted so that frame 0 has no rotation
    r_rot_ang = torch.cumsum(
        torch.cat([torch.zeros_like(rot_vel[..., :1]), rot_vel[..., :-1]], dim=-1), dim=-1)
    zeros = torch.zeros_like(r_rot_ang)
    r_rot_quat = torch.stack([torch.cos(r_rot_ang), zeros, torch.sin(r_rot_ang), zeros], dim=-1)

    # the shifted XZ velocity, rotated into the world frame and integrated
    vel_xz = torch.cat([torch.zeros_like(data[..., :1, 1:3]), data[..., :-1, 1:3]], dim=-2)
    r_pos = torch.cat([vel_xz[..., 0:1], torch.zeros_like(vel_xz[..., 0:1]), vel_xz[..., 1:2]],
                      dim=-1)
    r_pos = torch.cumsum(qrot(qinv(r_rot_quat), r_pos), dim=-2)
    r_pos = torch.cat([r_pos[..., :1], data[..., 3:4], r_pos[..., 2:]], dim=-1)
    return r_rot_quat, r_pos


def recover_from_ric(data: torch.Tensor, joints_num: int) -> torch.Tensor:
    """Rotation-invariant coordinates [..., T, D] -> world joint positions
    [..., T, J, 3]."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    positions = data[..., 4:(joints_num - 1) * 3 + 4]
    positions = positions.reshape(positions.shape[:-1] + (joints_num - 1, 3))
    inv = qinv(r_rot_quat)[..., None, :].expand(positions.shape[:-1] + (4,))
    positions = qrot(inv, positions)
    offset = torch.stack([r_pos[..., 0], torch.zeros_like(r_pos[..., 0]), r_pos[..., 2]], -1)
    positions = positions + offset[..., None, :]
    return torch.cat([r_pos[..., None, :], positions], dim=-2)


def _cont6d_of_features(data: torch.Tensor, joints_num: int, r_rot_quat: torch.Tensor):
    """The root's yaw and the joints' rotation features as cont6d
    [..., T, J * 6]."""
    start = 1 + 2 + 1 + (joints_num - 1) * 3
    end = start + (joints_num - 1) * 6
    return torch.cat([quaternion_to_cont6d(r_rot_quat), data[..., start:end]], dim=-1)


def recover_from_rot(data: torch.Tensor, joints_num: int, skeleton, offsets: torch.Tensor
                     ) -> torch.Tensor:
    """Rotation features [..., T, D] -> world joint positions [N, J, 3]
    (N the leading dims flattened) through ``skeleton``'s cont6d FK
    (ops/skeleton.py)."""
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    cont6d = _cont6d_of_features(data, joints_num, r_rot_quat).reshape(-1, joints_num, 6)
    return skeleton.forward_kinematics_cont6d(cont6d, r_pos.reshape(-1, 3), offsets)


def recover_rot(data: torch.Tensor) -> torch.Tensor:
    """Features [..., T, D] -> each joint's cont6d and a last row of the
    root translation padded with zeros, [..., T, J + 1, 6]."""
    joints_num = 22 if data.shape[-1] == 263 else 21
    r_rot_quat, r_pos = recover_root_rot_pos(data)
    r_pos_pad = torch.cat([r_pos, torch.zeros_like(r_pos)], dim=-1)[..., None, :]
    cont6d = _cont6d_of_features(data, joints_num, r_rot_quat)
    cont6d = cont6d.reshape(data.shape[:-1] + (joints_num, 6))
    return torch.cat([cont6d, r_pos_pad], dim=-2)
