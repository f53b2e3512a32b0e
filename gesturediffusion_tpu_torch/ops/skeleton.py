"""Kinematic-chain skeleton with forward and inverse kinematics.

PyTorch counterpart of gesturediffusion_tpu/ops/skeleton.py
(``parents_from_chains`` :31, ``Skeleton`` :40-194): the chains are static
metadata, so each chain's rotation accumulates in a short unrolled run of
batched quaternion products (``forward_kinematics``) or 3x3 matrix
products (``forward_kinematics_cont6d``, in float32 with TF32 off, as JAX
runs them at Precision.HIGHEST).  Inverse kinematics is host preprocessing
and stays in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gesturediffusion_tpu_torch.ops import quaternion as quat_ops
from gesturediffusion_tpu_torch.ops.quaternion_np import qbetween_np, qinv_np, qmul_np


def parents_from_chains(num_joints: int, chains: Sequence[Sequence[int]]) -> list[int]:
    parents = [0] * num_joints
    parents[0] = -1
    for chain in chains:
        for j in range(1, len(chain)):
            parents[chain[j]] = chain[j - 1]
    return parents


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Static topology and per-joint raw offset directions.

    ``raw_offsets``: (J, 3) unit offset directions (numpy).
    ``kinematic_tree``: chains; each starts at (or hangs off) the root and
    lists the joints along one limb.
    """

    raw_offsets: np.ndarray
    kinematic_tree: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        object.__setattr__(self, "raw_offsets", np.asarray(self.raw_offsets, np.float32))
        object.__setattr__(self, "kinematic_tree", tuple(tuple(c) for c in self.kinematic_tree))

    @property
    def njoints(self) -> int:
        return self.raw_offsets.shape[0]

    @property
    def parents(self) -> list[int]:
        return parents_from_chains(self.njoints, self.kinematic_tree)

    def get_offsets_joints(self, joints: np.ndarray) -> np.ndarray:
        """Raw offset directions scaled by the bone lengths of one pose (J, 3)."""
        joints = np.asarray(joints)
        offsets = self.raw_offsets.astype(np.float64).copy()
        parents = self.parents
        for i in range(1, self.njoints):
            offsets[i] = np.linalg.norm(joints[i] - joints[parents[i]]) * offsets[i]
        return offsets.astype(np.float32)

    def forward_kinematics(self, quat_params: torch.Tensor, root_pos: torch.Tensor,
                           offsets: torch.Tensor, do_root_R: bool = True) -> torch.Tensor:
        """Local joint quaternions (B, J, 4), root positions (B, 3) and
        offsets (J, 3) or (B, J, 3) -> joint positions (B, J, 3)."""
        if offsets.ndim == 2:
            offsets = offsets.expand(quat_params.shape[:-2] + offsets.shape)
        joints = [None] * self.njoints
        joints[0] = root_pos
        identity = quat_params.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(quat_params[:, 0].shape)
        for chain in self.kinematic_tree:
            R = quat_params[:, 0] if do_root_R else identity
            for i in range(1, len(chain)):
                R = quat_ops.qmul(R, quat_params[:, chain[i]])
                joints[chain[i]] = quat_ops.qrot(R, offsets[:, chain[i]]) + joints[chain[i - 1]]
        return torch.stack(joints, dim=1)

    def forward_kinematics_cont6d(self, cont6d_params: torch.Tensor, root_pos: torch.Tensor,
                                  offsets: torch.Tensor, do_root_R: bool = True) -> torch.Tensor:
        """Column-convention 6D local rotations (B, J, 6), root positions
        (B, 3) and offsets (J, 3) or (B, J, 3) -> joint positions (B, J, 3)."""
        if offsets.ndim == 2:
            offsets = offsets.expand(cont6d_params.shape[:-2] + offsets.shape)
        mats = quat_ops.cont6d_to_matrix(cont6d_params)  # (B, J, 3, 3)
        joints = [None] * self.njoints
        joints[0] = root_pos
        eye = torch.eye(3, dtype=mats.dtype, device=mats.device).expand(mats[:, 0].shape)
        for chain in self.kinematic_tree:
            matR = mats[:, 0] if do_root_R else eye
            for i in range(1, len(chain)):
                matR = torch.matmul(matR, mats[:, chain[i]])
                joints[chain[i]] = (torch.matmul(matR, offsets[:, chain[i]][..., None])[..., 0]
                                    + joints[chain[i - 1]])
        return torch.stack(joints, dim=1)

    def inverse_kinematics_np(self, joints: np.ndarray, face_joint_idx: Sequence[int],
                              smooth_forward: bool = False) -> np.ndarray:
        """Joint positions (T, J, 3) -> local quaternions (T, J, 4).

        face_joint_idx: (r_hip, l_hip, r_shoulder, l_shoulder), which give
        the root's facing direction.
        """
        if len(face_joint_idx) != 4:
            raise ValueError(f"face_joint_idx needs 4 joints, got {len(face_joint_idx)}")
        l_hip, r_hip, sdr_r, sdr_l = face_joint_idx
        across = (joints[:, r_hip] - joints[:, l_hip]) + (joints[:, sdr_r] - joints[:, sdr_l])
        across = across / np.linalg.norm(across, axis=-1, keepdims=True)

        forward = np.cross(np.array([[0.0, 1.0, 0.0]]), across, axis=-1)
        if smooth_forward:
            import scipy.ndimage

            forward = scipy.ndimage.gaussian_filter1d(forward, 20, axis=0, mode="nearest")
        forward = forward / np.linalg.norm(forward, axis=-1, keepdims=True)

        target = np.tile(np.array([[0.0, 0.0, 1.0]]), (len(forward), 1))
        root_quat = qbetween_np(forward, target)

        quat_params = np.zeros(joints.shape[:-1] + (4,))
        root_quat[0] = np.array([1.0, 0.0, 0.0, 0.0])
        quat_params[:, 0] = root_quat
        for chain in self.kinematic_tree:
            R = root_quat
            for j in range(len(chain) - 1):
                u = np.tile(self.raw_offsets[chain[j + 1]][None], (len(joints), 1))
                v = joints[:, chain[j + 1]] - joints[:, chain[j]]
                v = v / np.linalg.norm(v, axis=-1, keepdims=True)
                R_loc = qmul_np(qinv_np(R), qbetween_np(u, v))
                quat_params[:, chain[j + 1]] = R_loc
                R = qmul_np(R, R_loc)
        return quat_params
