"""Model output -> HumanIK joint rotations JSON (Maya / MotionBuilder).

PyTorch counterpart of gesturediffusion_tpu/viz/motions2hik.py (:25-68):
each repetition's xyz motion is fitted by SMPLify (viz/joints2smpl.py, on
the card unless ``device="cpu"``), its axis-angle poses turned into XYZ
Euler degrees (ops/rotations.py ``matrix_to_euler_angles``), and SMPL's
first 22 joints named as HumanIK's.
"""

from __future__ import annotations

import numpy as np
import torch

from gesturediffusion_tpu_torch.models.smpl import SMPLModel
from gesturediffusion_tpu_torch.ops import rotations as R
from gesturediffusion_tpu_torch.viz.joints2smpl import joints2smpl

# SMPL joint index -> HumanIK joint name (the first 22 SMPL joints)
HIK_JOINT_MAP = [
    "Hips", "LeftUpLeg", "RightUpLeg", "Spine", "LeftLeg", "RightLeg",
    "Spine1", "LeftFoot", "RightFoot", "Spine2", "LeftToeBase",
    "RightToeBase", "Neck", "LeftShoulder", "RightShoulder", "Head",
    "LeftArm", "RightArm", "LeftForeArm", "RightForeArm", "LeftHand",
    "RightHand",
]


def motions2hik(
    motions: np.ndarray,  # [num_reps, num_joints, 3, num_frames] xyz
    smpl: SMPLModel,
    num_smplify_iters: int = 150,
    device=None,
) -> dict:
    """xyz motions -> a JSON-serialisable dict of per-joint Euler rotations
    (degrees) and the hips' translation, a frame of a repetition each."""
    nreps, _, _, nframes = motions.shape
    thetas, root_translation = [], []
    for rep_idx in range(nreps):
        fit = joints2smpl(smpl, motions[rep_idx].transpose(2, 0, 1),
                          num_smplify_iters=num_smplify_iters, device=device)
        mats = R.axis_angle_to_matrix(torch.from_numpy(fit["thetas"]))
        eulers = np.degrees(R.matrix_to_euler_angles(mats, "XYZ").numpy())  # [T, 24, 3]
        thetas.append(eulers[:, : len(HIK_JOINT_MAP)])
        root_translation.append(fit["root_translation"])

    thetas = np.stack(thetas)  # [R, T, 22, 3]
    root_translation = np.stack(root_translation)
    frames = []
    for rep_idx in range(nreps):
        rep_frames = []
        for f in range(nframes):
            joints = {name: thetas[rep_idx, f, j].tolist() for j, name in enumerate(HIK_JOINT_MAP)}
            joints["HipsTranslation"] = root_translation[rep_idx, f].tolist()
            rep_frames.append(joints)
        frames.append(rep_frames)
    return {
        "joint_map": HIK_JOINT_MAP,
        "num_repetitions": nreps,
        "num_frames": nframes,
        "frames": frames,
    }
