"""Rotations -> xyz joints through SMPL forward kinematics.

PyTorch counterpart of gesturediffusion_tpu/models/rotation2xyz.py
(:30-123): pose representation -> rotation matrices -> SMPL -> the joint
set asked for -> root at the origin -> optional translation.  The training
losses' ``fk_fn`` is ``rotation2xyz(smpl, x, pose_rep="rot6d",
translation=True, glob=True, jointstype="smpl", vertstrans=False)``, which
runs SMPL's kinematic chain only (models/smpl.py).  Masked frames are
computed and then zeroed, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from gesturediffusion_tpu_torch.models.smpl import JOINTSTYPE_ROOT, SMPLModel
from gesturediffusion_tpu_torch.ops import rotations as geometry

JOINTSTYPES = ("a2m", "a2mpl", "smpl", "vibe", "vertices")


def rotation2xyz(
    smpl: SMPLModel,
    x: torch.Tensor,                      # [B, J(+1 translation row), F, T]
    mask: Optional[torch.Tensor] = None,  # [B, T] bool
    pose_rep: str = "rot6d",
    translation: bool = True,
    glob: bool = True,
    jointstype: str = "smpl",
    vertstrans: bool = False,
    betas: Optional[torch.Tensor] = None,
    beta: float = 0.0,
    glob_rot: Optional[tuple] = None,
    get_rotations_back: bool = False,
):
    """x rotations -> xyz joints [B, J', 3, T] (the vertices for
    ``jointstype="vertices"``)."""
    if pose_rep == "xyz":
        return x
    if jointstype not in JOINTSTYPES:
        raise NotImplementedError("This jointstype is not implemented.")
    if not glob and glob_rot is None:
        raise TypeError("You must specify global rotation if glob is False")

    if translation:
        x_translations = x[:, -1, :3]  # [B, 3, T]
        x_rotations = x[:, :-1]
    else:
        x_translations = None
        x_rotations = x

    x_rotations = x_rotations.permute(0, 3, 1, 2)  # [B, T, J, F]
    nsamples, time, njoints, feats = x_rotations.shape
    flat = x_rotations.reshape(nsamples * time, njoints, feats)

    if pose_rep == "rotvec":
        rotations = geometry.axis_angle_to_matrix(flat)
    elif pose_rep == "rotmat":
        rotations = flat.reshape(-1, njoints, 3, 3)
    elif pose_rep == "rotquat":
        rotations = geometry.quaternion_to_matrix(flat)
    elif pose_rep == "rot6d":
        rotations = geometry.rotation_6d_to_matrix(flat)
    else:
        raise NotImplementedError("No geometry for this one.")

    if not glob:
        global_orient = geometry.axis_angle_to_matrix(
            torch.as_tensor(glob_rot, dtype=rotations.dtype, device=rotations.device))
        global_orient = global_orient.expand(rotations.shape[0], 3, 3)
    else:
        global_orient = rotations[:, 0]
        rotations = rotations[:, 1:]

    if betas is None:
        betas = rotations.new_zeros((rotations.shape[0], smpl.num_betas))
        betas[:, 1] = beta

    out = smpl(body_pose=rotations, global_orient=global_orient, betas=betas,
               sets=(jointstype,))
    joints = out[jointstype]  # [B*T, J', 3]

    x_xyz = joints.reshape(nsamples, time, joints.shape[1], 3)
    if mask is not None:
        x_xyz = torch.where(mask[:, :, None, None], x_xyz, x_xyz.new_zeros(()))
    x_xyz = x_xyz.permute(0, 2, 3, 1)  # [B, J', 3, T]

    # the root at the origin
    if jointstype != "vertices":
        rootindex = JOINTSTYPE_ROOT[jointstype]
        x_xyz = x_xyz - x_xyz[:, rootindex:rootindex + 1]

    if translation and vertstrans:
        x_translations = x_translations - x_translations[:, :, 0:1]
        x_xyz = x_xyz + x_translations[:, None]

    if get_rotations_back:
        return x_xyz, rotations, global_orient
    return x_xyz


class Rotation2xyz:
    """The reference's callable wrapper around ``rotation2xyz``."""

    def __init__(self, smpl: SMPLModel, dataset: str = "amass"):
        self.smpl_model = smpl
        self.dataset = dataset

    def __call__(self, x, mask=None, **kwargs):
        return rotation2xyz(self.smpl_model, x, mask, **kwargs)
