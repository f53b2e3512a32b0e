"""SMPL body model: linear blend skinning on torch tensors.

PyTorch counterpart of gesturediffusion_tpu/models/smpl.py: shape
blendshapes, pose blendshapes, the rigid transforms down the 24-joint
kinematic chain and skinning, with the joint sets ``smpl``, ``vibe``,
``a2m`` and ``a2mpl`` (the reference SMPL wrapper's JOINT_MAP /
JOINT_NAMES tables).  ``SMPLModel`` is an nn.Module whose tables are
buffers, so ``.to(device)`` moves it to the card.

The ``smpl`` joints come from the kinematic chain alone.  A call that asks
only for them (``sets=("smpl",)``, as rotation2xyz does for the training
losses) skips the vertex path: the pose blendshapes ([N, 207] x [207, 3V])
and the per-vertex skinning transforms ([N, V, 4, 4]), which at 64 x 60
frames and 6890 vertices are 33 GFLOP and 1.7 GB a call.  The rest joints
are regressed from precomputed tables (the regressor applied to the
template and to the shape directions), so both paths give the same joints
bit for bit.  The 23 chain products run in float32 with TF32 off, as JAX
runs them at Precision.HIGHEST.

``load_smpl_pickle`` reads the official pickle without chumpy (a stub
unpickler); ``make_synthetic_smpl`` and ``save_synthetic_smpl_pickle``
make a random model in that layout from the same numpy draws as the JAX
package, so a seed gives the same tables in both.
"""

from __future__ import annotations

import pickle
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# SMPL kinematic tree (24 joints), parent of joint i
SMPL_PARENTS = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
    18, 19, 20, 21,
)

# the surface vertices smplx's VertexJointSelector appends as joints 24..44
SMPL_VERTEX_JOINT_IDS = {
    "nose": 332, "reye": 6260, "leye": 2800, "rear": 4071, "lear": 583,
    "rthumb": 6191, "rindex": 5782, "rmiddle": 5905, "rring": 6016,
    "rpinky": 6133, "lthumb": 2746, "lindex": 2319, "lmiddle": 2445,
    "lring": 2556, "lpinky": 2673, "LBigToe": 3216, "LSmallToe": 3226,
    "LHeel": 3387, "RBigToe": 6617, "RSmallToe": 6624, "RHeel": 6787,
}
# smplx's order: face, then feet, then hands
SMPL_VERTEX_JOINT_ORDER = (
    "nose", "reye", "leye", "rear", "lear",
    "LBigToe", "LSmallToe", "LHeel", "RBigToe", "RSmallToe", "RHeel",
    "lthumb", "lindex", "lmiddle", "lring", "lpinky",
    "rthumb", "rindex", "rmiddle", "rring", "rpinky",
)

# positions in JOINT_NAMES of action2motion's 18 joints
ACTION2MOTION_JOINTS = (8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14,
                        21, 24, 38)

JOINT_MAP = {
    "OP Nose": 24, "OP Neck": 12, "OP RShoulder": 17, "OP RElbow": 19,
    "OP RWrist": 21, "OP LShoulder": 16, "OP LElbow": 18, "OP LWrist": 20,
    "OP MidHip": 0, "OP RHip": 2, "OP RKnee": 5, "OP RAnkle": 8,
    "OP LHip": 1, "OP LKnee": 4, "OP LAnkle": 7, "OP REye": 25,
    "OP LEye": 26, "OP REar": 27, "OP LEar": 28, "OP LBigToe": 29,
    "OP LSmallToe": 30, "OP LHeel": 31, "OP RBigToe": 32,
    "OP RSmallToe": 33, "OP RHeel": 34, "Right Ankle": 8, "Right Knee": 5,
    "Right Hip": 45, "Left Hip": 46, "Left Knee": 4, "Left Ankle": 7,
    "Right Wrist": 21, "Right Elbow": 19, "Right Shoulder": 17,
    "Left Shoulder": 16, "Left Elbow": 18, "Left Wrist": 20,
    "Neck (LSP)": 47, "Top of Head (LSP)": 48, "Pelvis (MPII)": 49,
    "Thorax (MPII)": 50, "Spine (H36M)": 51, "Jaw (H36M)": 52,
    "Head (H36M)": 53, "Nose": 24, "Left Eye": 26, "Right Eye": 25,
    "Left Ear": 28, "Right Ear": 27,
}

JOINT_NAMES = [
    "OP Nose", "OP Neck", "OP RShoulder", "OP RElbow", "OP RWrist",
    "OP LShoulder", "OP LElbow", "OP LWrist", "OP MidHip", "OP RHip",
    "OP RKnee", "OP RAnkle", "OP LHip", "OP LKnee", "OP LAnkle",
    "OP REye", "OP LEye", "OP REar", "OP LEar", "OP LBigToe",
    "OP LSmallToe", "OP LHeel", "OP RBigToe", "OP RSmallToe", "OP RHeel",
    "Right Ankle", "Right Knee", "Right Hip", "Left Hip", "Left Knee",
    "Left Ankle", "Right Wrist", "Right Elbow", "Right Shoulder",
    "Left Shoulder", "Left Elbow", "Left Wrist", "Neck (LSP)",
    "Top of Head (LSP)", "Pelvis (MPII)", "Thorax (MPII)",
    "Spine (H36M)", "Jaw (H36M)", "Head (H36M)", "Nose", "Left Eye",
    "Right Eye", "Left Ear", "Right Ear",
]

JOINTSTYPE_ROOT = {"a2m": 0, "smpl": 0, "a2mpl": 0, "vibe": 8}

# indices into the 45 (or 54, with the extra regressor) joints
VIBE_INDEX = np.asarray([JOINT_MAP[n] for n in JOINT_NAMES])
A2M_INDEX = VIBE_INDEX[list(ACTION2MOTION_JOINTS)]
A2MPL_INDEX = np.unique(np.r_[np.arange(24), A2M_INDEX])
# the sets that read the vertices (the rest need only the chain)
VERTEX_SETS = ("vertices", "vibe", "a2m", "a2mpl")


class SMPLModel(nn.Module):
    """SMPL tables as buffers and the static topology."""

    def __init__(self, v_template, shapedirs, posedirs, j_regressor, lbs_weights,
                 j_regressor_extra=None, parents: Sequence[int] = SMPL_PARENTS,
                 vertex_joint_ids: Optional[Sequence[int]] = None):
        super().__init__()

        def buf(name, a):
            self.register_buffer(name, torch.as_tensor(np.asarray(a, np.float32)))

        buf("v_template", v_template)                # [V, 3]
        buf("shapedirs", shapedirs)                  # [V, 3, n_betas]
        buf("posedirs", posedirs)                    # [(J-1)*9, V*3]
        buf("j_regressor", j_regressor)              # [J, V]
        buf("lbs_weights", lbs_weights)              # [V, J]
        if j_regressor_extra is None:
            self.register_buffer("j_regressor_extra", None)
        else:
            buf("j_regressor_extra", j_regressor_extra)  # [9, V]
        # the rest joints' tables: the regressor applied to the template
        # and to each shape direction, in float64
        jr = np.asarray(j_regressor, np.float64)
        buf("j_template", jr @ np.asarray(v_template, np.float64))           # [J, 3]
        buf("j_shapedirs", np.einsum("jv,vdl->jdl", jr,
                                     np.asarray(shapedirs, np.float64)))     # [J, 3, n_betas]
        self.parents = tuple(int(p) for p in parents)
        self.vertex_joint_ids = tuple(int(i) for i in (
            vertex_joint_ids if vertex_joint_ids is not None
            else (SMPL_VERTEX_JOINT_IDS[n] for n in SMPL_VERTEX_JOINT_ORDER)))

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_betas(self) -> int:
        return int(self.shapedirs.shape[-1])

    def lbs(self, betas: torch.Tensor, pose_mats: torch.Tensor,
            transl: Optional[torch.Tensor] = None, vertices: bool = True):
        """Linear blend skinning: betas [B, n_betas], pose_mats [B, J, 3, 3]
        (the global orientation at 0) -> (vertices [B, V, 3] or None when
        ``vertices`` is False, joints [B, J, 3])."""
        b = betas.shape[0]
        dtype = pose_mats.dtype
        joints_rest = self.j_template.to(dtype) + torch.einsum(
            "bl,jdl->bjd", betas, self.j_shapedirs.to(dtype))

        def make_tf(rot, t):
            # [B, 3, 3], [B, 3] -> [B, 4, 4]
            top = torch.cat([rot, t[..., None]], dim=-1)
            bottom = pose_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(b, 1, 4)
            return torch.cat([top, bottom], dim=-2)

        transforms = [make_tf(pose_mats[:, 0], joints_rest[:, 0])]
        for j in range(1, self.num_joints):
            p = self.parents[j]
            local = make_tf(pose_mats[:, j], joints_rest[:, j] - joints_rest[:, p])
            transforms.append(torch.matmul(transforms[p], local))
        G = torch.stack(transforms, dim=1)  # [B, J, 4, 4]
        joints = G[..., :3, 3]
        if transl is not None:
            joints = joints + transl[:, None]
        if not vertices:
            return None, joints

        v_shaped = self.v_template + torch.einsum("bl,vdl->bvd", betas, self.shapedirs)
        eye = torch.eye(3, dtype=dtype, device=pose_mats.device)
        pose_feature = (pose_mats[:, 1:] - eye).reshape(b, -1)
        v_posed = v_shaped + (pose_feature @ self.posedirs).reshape(b, -1, 3)
        # remove the rest pose's share of each transform
        rest = torch.einsum("bjmn,bjn->bjm", G[..., :3, :3], joints_rest)
        A = torch.cat([G[..., :3, :3], (G[..., :3, 3] - rest)[..., None]], dim=-1)  # [B, J, 3, 4]
        T = torch.einsum("vj,bjmn->bvmn", self.lbs_weights, A)
        verts = torch.einsum("bvmn,bvn->bvm", T[..., :3], v_posed) + T[..., 3]
        if transl is not None:
            verts = verts + transl[:, None]
        return verts, joints

    def forward(self, body_pose: torch.Tensor, global_orient: torch.Tensor,
                betas: Optional[torch.Tensor] = None, transl: Optional[torch.Tensor] = None,
                sets: Optional[Sequence[str]] = None) -> dict:
        """body_pose [B, J-1, 3, 3], global_orient [B, 3, 3] -> {"vertices",
        "smpl", and "vibe", "a2m", "a2mpl" where their joints are in range}
        (smpl.py:176-215).  ``sets`` names the entries wanted; without a
        vertex-based one the vertices are not computed."""
        b = body_pose.shape[0]
        if betas is None:
            betas = body_pose.new_zeros((b, self.num_betas))
        pose_mats = torch.cat([global_orient[:, None], body_pose], dim=1)
        need_verts = sets is None or any(s in VERTEX_SETS for s in sets)
        verts, joints = self.lbs(betas, pose_mats, transl, vertices=need_verts)
        out = {"smpl": joints}
        if not need_verts:
            return out
        out["vertices"] = verts
        # 45 smplx-style joints: 24 of the skeleton, 21 surface vertices
        all_joints = torch.cat([joints, verts[:, list(self.vertex_joint_ids)]], dim=1)
        if self.j_regressor_extra is not None:
            extra = torch.einsum("jv,bvd->bjd", self.j_regressor_extra, verts)
            all_joints = torch.cat([all_joints, extra], dim=1)
        n_all = all_joints.shape[1]
        # a set whose indices fall outside the joints is left out rather
        # than gathered out of range
        if n_all > int(VIBE_INDEX.max()):
            out["vibe"] = all_joints[:, VIBE_INDEX]
        if n_all > int(A2M_INDEX.max()):
            out["a2m"] = all_joints[:, A2M_INDEX]
            out["a2mpl"] = all_joints[:, A2MPL_INDEX]
        return out


# ---------------------------------------------------------------------- #
# weights: the official pickle and the synthetic stand-in
# ---------------------------------------------------------------------- #
class _ChumpyStub:
    """Takes the place of a pickled chumpy array; the numpy payload is in
    its state."""

    def __setstate__(self, state):
        self.__dict__.update(state)

    def to_numpy(self):
        for key in ("x", "v", "r", "a"):
            if key in self.__dict__:
                val = self.__dict__[key]
                if isinstance(val, _ChumpyStub):
                    return val.to_numpy()
                return np.asarray(val)
        raise ValueError("cannot extract array from chumpy stub")


class _SMPLUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_np(x):
    if isinstance(x, _ChumpyStub):
        return x.to_numpy()
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def _parents_from_kintree(data) -> tuple:
    # the root's parent is stored as uint32(-1)
    parents = _to_np(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    return tuple(int(p) for p in parents)


def read_smpl_pickle_dict(path: str) -> dict:
    """The SMPL pickle's dict, read without chumpy (its arrays as numpy)."""
    with open(path, "rb") as f:
        data = _SMPLUnpickler(f, encoding="latin1").load()
    return {k: _to_np(v) if isinstance(v, _ChumpyStub) else v for k, v in data.items()}


def load_smpl_pickle(path: str) -> SMPLModel:
    """The official SMPL pickle (or a synthetic one in its layout) ->
    SMPLModel on the CPU, without chumpy (smpl.py:249)."""
    data = read_smpl_pickle_dict(path)
    shapedirs = _to_np(data["shapedirs"])[..., :10]
    posedirs = _to_np(data["posedirs"])
    posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # [(J-1)*9, V*3]
    v_template = _to_np(data["v_template"])
    n_verts = v_template.shape[0]
    # the official pickle carries no surface-joint ids (the real mesh uses
    # the constant table); a synthetic one keeps its own.  On a mesh
    # smaller than the table's ids they are taken modulo the vertex count,
    # as the JAX package does
    if "vertex_joint_ids" in data:
        vertex_ids = tuple(int(i) for i in data["vertex_joint_ids"])
    else:
        vertex_ids = tuple(SMPL_VERTEX_JOINT_IDS[n] for n in SMPL_VERTEX_JOINT_ORDER)
        if n_verts <= max(vertex_ids):
            vertex_ids = tuple(i % n_verts for i in vertex_ids)
    return SMPLModel(
        v_template=v_template,
        shapedirs=shapedirs,
        posedirs=posedirs,
        j_regressor=_to_np(data["J_regressor"]),
        lbs_weights=_to_np(data["weights"]),
        j_regressor_extra=(_to_np(data["J_regressor_extra"])
                           if "J_regressor_extra" in data else None),
        parents=_parents_from_kintree(data) if "kintree_table" in data else SMPL_PARENTS,
        vertex_joint_ids=vertex_ids,
    )


def _synthetic_tables(n_vertices: int, n_betas: int, seed: int) -> dict:
    """The random tables of a small SMPL-like model (24 joints), in the
    JAX package's draw order."""
    rs = np.random.RandomState(seed)
    nj = 24
    v_template = rs.randn(n_vertices, 3).astype(np.float32) * 0.3
    # each joint regresses from a few vertices
    j_reg = np.zeros((nj, n_vertices), np.float32)
    for j in range(nj):
        j_reg[j, rs.choice(n_vertices, 4, replace=False)] = 0.25
    lbs_w = rs.rand(n_vertices, nj).astype(np.float32) ** 4
    lbs_w = lbs_w / lbs_w.sum(-1, keepdims=True)
    vertex_ids = tuple(int(i) for i in rs.choice(n_vertices, 21, replace=False))
    # a 9-joint extra regressor, so that the vibe and a2m sets exist
    extra_reg = np.zeros((9, n_vertices), np.float32)
    for j in range(9):
        extra_reg[j, rs.choice(n_vertices, 4, replace=False)] = 0.25
    return dict(
        v_template=v_template,
        shapedirs=rs.randn(n_vertices, 3, n_betas).astype(np.float32) * 0.01,
        posedirs=rs.randn((nj - 1) * 9, n_vertices * 3).astype(np.float32) * 0.001,
        j_regressor=j_reg,
        lbs_weights=lbs_w,
        j_regressor_extra=extra_reg,
        parents=SMPL_PARENTS,
        vertex_joint_ids=vertex_ids,
    )


def make_synthetic_smpl(n_vertices: int = 128, n_betas: int = 10, seed: int = 0) -> SMPLModel:
    """A random SMPL-like model (24 joints) for tests and smoke runs
    (smpl.py:332)."""
    return SMPLModel(**_synthetic_tables(n_vertices, n_betas, seed))


def save_synthetic_smpl_pickle(path: str, n_vertices: int = 96, seed: int = 0) -> str:
    """Write a random SMPL model in the official pickle layout
    (v_template, shapedirs [V,3,B], posedirs [V,3,(J-1)*9], J_regressor,
    weights, kintree_table), plus its surface-joint ids and extra regressor,
    so that load_smpl_pickle and the CLIs run without the real asset
    (smpl.py:296)."""
    m = _synthetic_tables(n_vertices, 10, seed)
    nj = 24
    kintree = np.zeros((2, nj), np.uint32)
    kintree[0] = np.asarray([np.uint32(p) if p >= 0 else np.uint32(2**32 - 1)
                             for p in m["parents"]], np.uint32)
    kintree[1] = np.arange(nj, dtype=np.uint32)
    data = {
        "v_template": m["v_template"],
        "shapedirs": m["shapedirs"],
        "posedirs": m["posedirs"].T.reshape(n_vertices, 3, (nj - 1) * 9),
        "J_regressor": m["j_regressor"],
        "weights": m["lbs_weights"],
        "kintree_table": kintree,
        "vertex_joint_ids": np.asarray(m["vertex_joint_ids"], np.int64),
        "J_regressor_extra": m["j_regressor_extra"],
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path
