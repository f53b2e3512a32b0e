"""HumanML3D feature extraction (the forward codec), host numpy.

Copy of gesturediffusion_tpu/ops/motion_features.py for the port
(``uniform_skeleton`` :57, ``extract_features`` :82, ``process_file`` :154):
uniform-skeleton retargeting, floor alignment, origin and facing
normalisation, foot-contact detection, IK -> cont6d rotations, RIC
positions and local velocities -> the 263-dim (22-joint) / 251-dim
(21-joint) feature vector.  The inverse codec is ops/motion_process.py.
"""

from __future__ import annotations

import numpy as np

from gesturediffusion_tpu_torch.ops.quaternion_np import (
    qbetween_np,
    qfix_np,
    qinv_np,
    qmul_np,
    qrot_np,
    quaternion_to_cont6d_np,
)
from gesturediffusion_tpu_torch.ops.skeleton import Skeleton
from gesturediffusion_tpu_torch.utils import paramutil

# HumanML3D (t2m) constants (reference: motion_process.py __main__ block)
T2M_FACE_JOINTS = (2, 1, 17, 16)  # r_hip, l_hip, sdr_r, sdr_l
T2M_FID_R = (8, 11)
T2M_FID_L = (7, 10)
T2M_LEG_IDX = (5, 8)  # lower legs used for uniform-skeleton scaling

# KIT constants
KIT_FACE_JOINTS = (11, 16, 5, 8)
KIT_FID_R = (14, 15)
KIT_FID_L = (19, 20)
KIT_LEG_IDX = (5, 8)


def _fk_np(skel: Skeleton, quat_params, root_pos, offsets):
    """numpy FK wrapper over the (jit-free) quaternion chain math."""
    t = quat_params.shape[0]
    joints = np.zeros(quat_params.shape[:-1] + (3,))
    joints[:, 0] = root_pos
    for chain in skel.kinematic_tree:
        R = quat_params[:, 0]
        for i in range(1, len(chain)):
            R = qmul_np(R, quat_params[:, chain[i]])
            joints[:, chain[i]] = (
                qrot_np(R, np.tile(offsets[chain[i]], (t, 1)))
                + joints[:, chain[i - 1]]
            )
    return joints


def uniform_skeleton(
    positions: np.ndarray,
    target_offsets: np.ndarray,
    skel: Skeleton,
    face_joint_indx=T2M_FACE_JOINTS,
    leg_idx=T2M_LEG_IDX,
) -> np.ndarray:
    """Retarget a joint sequence onto the canonical skeleton via IK+FK."""
    src_offset = skel.get_offsets_joints(positions[0])
    tgt_offset = np.asarray(target_offsets)
    l_idx1, l_idx2 = leg_idx
    src_leg_len = (
        np.abs(src_offset[l_idx1]).max() + np.abs(src_offset[l_idx2]).max()
    )
    tgt_leg_len = (
        np.abs(tgt_offset[l_idx1]).max() + np.abs(tgt_offset[l_idx2]).max()
    )
    scale_rt = tgt_leg_len / src_leg_len
    tgt_root_pos = positions[:, 0] * scale_rt

    quat_params = skel.inverse_kinematics_np(positions, face_joint_indx)
    return _fk_np(skel, quat_params, tgt_root_pos, tgt_offset)


def extract_features(
    positions: np.ndarray,  # (T, J, 3), already normalized/aligned
    feet_thre: float,
    skel: Skeleton,
    face_joint_indx=T2M_FACE_JOINTS,
    fid_r=T2M_FID_R,
    fid_l=T2M_FID_L,
    return_rifke: bool = False,
) -> np.ndarray:
    """Aligned positions -> feature vectors (T-1, 4 + (J-1)*9 + J*3 + 4).

    ``return_rifke=True`` additionally returns the rotation-invariant
    (root-XZ-removed AND per-frame-yaw-rotated) joint positions — the
    reference's get_rifke output (motion_process.py:68-74)."""
    positions = positions.copy()
    global_positions = positions.copy()

    # foot contacts from squared frame-to-frame displacement
    def foot_detect(pos, thres):
        velfactor = np.array([thres, thres])
        feet_l = (
            ((pos[1:, fid_l] - pos[:-1, fid_l]) ** 2).sum(-1) < velfactor
        ).astype(np.float32)
        feet_r = (
            ((pos[1:, fid_r] - pos[:-1, fid_r]) ** 2).sum(-1) < velfactor
        ).astype(np.float32)
        return feet_l, feet_r

    feet_l, feet_r = foot_detect(positions, feet_thre)

    # IK with smoothed forward, cont6d params, root angular/linear velocity
    quat_params = skel.inverse_kinematics_np(
        positions, face_joint_indx, smooth_forward=True
    )
    quat_params = qfix_np(quat_params)
    cont_6d_params = quaternion_to_cont6d_np(quat_params)
    r_rot = quat_params[:, 0].copy()
    velocity = qrot_np(r_rot[1:], positions[1:, 0] - positions[:-1, 0])
    r_velocity = qmul_np(r_rot[1:], qinv_np(r_rot[:-1]))

    # rotation-invariant local positions (root XZ removed, rotated to Z+)
    positions[..., 0] -= positions[:, 0:1, 0]
    positions[..., 2] -= positions[:, 0:1, 2]
    positions = qrot_np(
        np.repeat(r_rot[:, None], positions.shape[1], axis=1), positions
    )

    root_y = positions[:, 0, 1:2]
    r_velocity = np.arcsin(r_velocity[:, 2:3])
    l_velocity = velocity[:, [0, 2]]
    root_data = np.concatenate([r_velocity, l_velocity, root_y[:-1]], axis=-1)

    rot_data = cont_6d_params[:, 1:].reshape(len(cont_6d_params), -1)
    ric_data = positions[:, 1:].reshape(len(positions), -1)
    local_vel = qrot_np(
        np.repeat(r_rot[:-1, None], global_positions.shape[1], axis=1),
        global_positions[1:] - global_positions[:-1],
    ).reshape(len(positions) - 1, -1)

    data = np.concatenate(
        [root_data, ric_data[:-1], rot_data[:-1], local_vel, feet_l, feet_r],
        axis=-1,
    )
    if return_rifke:
        return data, positions
    return data


def process_file(
    positions: np.ndarray,  # (T, J, 3) raw joints
    feet_thre: float,
    tgt_offsets: np.ndarray,
    raw_offsets=None,
    kinematic_chain=None,
    face_joint_indx=T2M_FACE_JOINTS,
    fid_r=T2M_FID_R,
    fid_l=T2M_FID_L,
    leg_idx=T2M_LEG_IDX,
):
    """Full preprocessing: retarget, floor, origin/facing, features.

    Returns (features, global_positions, local_positions, l_velocity).
    """
    raw_offsets = (
        raw_offsets if raw_offsets is not None else paramutil.t2m_raw_offsets
    )
    kinematic_chain = kinematic_chain or paramutil.t2m_kinematic_chain
    skel = Skeleton(raw_offsets, tuple(tuple(c) for c in kinematic_chain))

    positions = uniform_skeleton(
        positions, tgt_offsets, skel, face_joint_indx, leg_idx
    )

    # put on floor
    positions[:, :, 1] -= positions.min(axis=0).min(axis=0)[1]

    # XZ at origin
    root_pos_init = positions[0]
    positions = positions - root_pos_init[0] * np.array([1, 0, 1])

    # all initially face Z+
    r_hip, l_hip, sdr_r, sdr_l = face_joint_indx
    across = (root_pos_init[r_hip] - root_pos_init[l_hip]) + (
        root_pos_init[sdr_r] - root_pos_init[sdr_l]
    )
    across = across / np.sqrt((across**2).sum())
    forward_init = np.cross(np.array([0, 1, 0]), across)
    forward_init = forward_init / np.sqrt((forward_init**2).sum())
    root_quat_init = qbetween_np(
        forward_init[None], np.array([[0, 0, 1]])
    )
    positions = qrot_np(
        np.broadcast_to(root_quat_init, positions.shape[:-1] + (4,)),
        positions,
    )

    global_positions = positions.copy()
    # 'local' is the reference's get_rifke output: root-XZ removed AND
    # rotated by the per-frame root yaw (motion_process.py:68-74) — the
    # XZ subtraction alone is NOT frame-consistent local pose
    data, local = extract_features(
        positions, feet_thre, skel, face_joint_indx, fid_r, fid_l,
        return_rifke=True,
    )
    l_velocity = data[:, 1:3]
    return data, global_positions, local, l_velocity
