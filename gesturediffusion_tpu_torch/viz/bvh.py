"""Minimal BVH (Biovision Hierarchy) reader and writer, host-side.

Copy of gesturediffusion_tpu/viz/bvh.py for the port (BvhJoint,
BvhSkeleton, read_bvh, write_bvh, make_default_skeleton,
export_gesture_bvh): a skeleton is a list of joints in hierarchy
(depth-first) order; motion is per-joint euler rotations (degrees, in the
joint's channel order) and translations for joints with position channels.
The files it writes are byte for byte the JAX package's for the same
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class BvhJoint:
    name: str
    offset: np.ndarray  # (3,)
    channels: list[str]  # e.g. ['Xposition', ..., 'Zrotation', ...]
    parent: Optional[int]  # index into the joint list, None for root
    children: list[int] = dataclasses.field(default_factory=list)
    is_end_site: bool = False
    # motion data (set by reader or caller)
    rotation: Optional[np.ndarray] = None  # (T, 3) euler deg, channel order
    translation: Optional[np.ndarray] = None  # (T, 3)

    @property
    def rot_order(self) -> str:
        """e.g. 'ZXY' from the rotation channels."""
        return "".join(c[0] for c in self.channels if c.endswith("rotation"))


@dataclasses.dataclass
class BvhSkeleton:
    joints: list[BvhJoint]
    frame_time: float = 1.0 / 30
    frames: int = 0

    @property
    def root(self) -> BvhJoint:
        return self.joints[0]

    def joint_names(self) -> list[str]:
        return [j.name for j in self.joints if not j.is_end_site]

    def list_of_joints(self) -> list[BvhJoint]:
        """Non-end-site joints in hierarchy order (bvhsdk getlistofjoints)."""
        return [j for j in self.joints if not j.is_end_site]


def _expect(ok: bool, what: str) -> None:
    """Raise on a malformed file (a check that survives python -O)."""
    if not ok:
        raise ValueError(f"malformed BVH: expected {what}")


def read_bvh(path: str, skip_motion: bool = False) -> BvhSkeleton:
    with open(path) as f:
        tokens = f.read().split()
    joints: list[BvhJoint] = []
    stack: list[int] = []

    i = 0
    _expect(tokens[i] == "HIERARCHY", "HIERARCHY")
    i += 1
    while i < len(tokens):
        tok = tokens[i]
        if tok in ("ROOT", "JOINT", "End"):
            if tok == "End":
                name = "End Site"
                i += 2  # 'End' 'Site'
                is_end = True
            else:
                name = tokens[i + 1]
                i += 2
                is_end = False
            _expect(tokens[i] == "{", "{")
            i += 1
            _expect(tokens[i] == "OFFSET", "OFFSET")
            offset = np.array([float(tokens[i + k]) for k in (1, 2, 3)])
            i += 4
            channels: list[str] = []
            if not is_end:
                _expect(tokens[i] == "CHANNELS", "CHANNELS")
                n = int(tokens[i + 1])
                channels = tokens[i + 2 : i + 2 + n]
                i += 2 + n
            parent = stack[-1] if stack else None
            idx = len(joints)
            joints.append(
                BvhJoint(name, offset, channels, parent, is_end_site=is_end)
            )
            if parent is not None:
                joints[parent].children.append(idx)
            stack.append(idx)
        elif tok == "}":
            stack.pop()
            i += 1
            if not stack:
                break
        else:
            i += 1

    # motion section
    sk = BvhSkeleton(joints)
    while i < len(tokens) and tokens[i] != "MOTION":
        i += 1
    if i >= len(tokens):
        return sk
    i += 1
    _expect(tokens[i] == "Frames:", "Frames:")
    sk.frames = int(tokens[i + 1])
    i += 2
    _expect(tokens[i] == "Frame" and tokens[i + 1] == "Time:", "Frame Time:")
    sk.frame_time = float(tokens[i + 2])
    i += 3
    if skip_motion:
        return sk

    n_ch = sum(len(j.channels) for j in joints)
    vals = np.array(tokens[i : i + sk.frames * n_ch], np.float64).reshape(
        sk.frames, n_ch
    )
    c = 0
    for j in joints:
        if not j.channels:
            continue
        block = vals[:, c : c + len(j.channels)]
        c += len(j.channels)
        rot = np.zeros((sk.frames, 3))
        trans = np.zeros((sk.frames, 3))
        has_rot = has_trans = False
        ri = 0
        for k, ch in enumerate(j.channels):
            if ch.endswith("rotation"):
                rot[:, ri] = block[:, k]
                ri += 1
                has_rot = True
            else:
                trans[:, "XYZ".index(ch[0])] = block[:, k]
                has_trans = True
        j.rotation = rot if has_rot else None
        j.translation = trans if has_trans else None
    return sk


def write_bvh(sk: BvhSkeleton, path: str, frame_time: Optional[float] = None):
    """Write hierarchy + motion.  Joints must carry rotation (T, 3) in their
    channel order; joints with position channels must carry translation."""
    frame_time = frame_time or sk.frame_time
    lines: list[str] = ["HIERARCHY"]

    def fmt_offset(o):
        return f"OFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}"

    def emit(idx: int, depth: int):
        j = sk.joints[idx]
        ind = "\t" * depth
        if j.is_end_site:
            lines.append(f"{ind}End Site")
            lines.append(f"{ind}{{")
            lines.append(f"{ind}\t{fmt_offset(j.offset)}")
            lines.append(f"{ind}}}")
            return
        kw = "ROOT" if j.parent is None else "JOINT"
        lines.append(f"{ind}{kw} {j.name}")
        lines.append(f"{ind}{{")
        lines.append(f"{ind}\t{fmt_offset(j.offset)}")
        lines.append(
            f"{ind}\tCHANNELS {len(j.channels)} " + " ".join(j.channels)
        )
        for c in j.children:
            emit(c, depth + 1)
        lines.append(f"{ind}}}")

    emit(0, 0)

    frames = sk.frames
    lines.append("MOTION")
    lines.append(f"Frames: {frames}")
    lines.append(f"Frame Time: {frame_time:.8f}")

    cols = []
    for j in sk.joints:
        if not j.channels:
            continue
        rot = j.rotation if j.rotation is not None else np.zeros((frames, 3))
        trans = (
            j.translation if j.translation is not None else np.zeros((frames, 3))
        )
        ri = 0
        for ch in j.channels:
            if ch.endswith("rotation"):
                cols.append(rot[:, ri])
                ri += 1
            else:
                cols.append(trans[:, "XYZ".index(ch[0])])
    data = np.stack(cols, axis=1)
    body = "\n".join(
        " ".join(f"{v:.6f}" for v in row) for row in np.asarray(data)
    )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + body + "\n")


def make_default_skeleton(
    n_joints: int, frame_time: float = 1.0 / 30
) -> BvhSkeleton:
    """A degenerate chain skeleton for exporting motion without a reference
    BVH (each joint a child of the previous, zero offsets).  Lets BVH export
    work when the GENEA reference skeleton file is unavailable."""
    joints = []
    for i in range(n_joints):
        channels = (
            ["Xposition", "Yposition", "Zposition",
             "Zrotation", "Xrotation", "Yrotation"]
            if i == 0
            else ["Zrotation", "Xrotation", "Yrotation"]
        )
        joints.append(
            BvhJoint(
                name=f"joint_{i}",
                offset=np.zeros(3),
                channels=channels,
                parent=None if i == 0 else i - 1,
            )
        )
        if i > 0:
            joints[i - 1].children.append(i)
    return BvhSkeleton(joints, frame_time=frame_time)


def export_gesture_bvh(
    path: str,
    rotations: np.ndarray,  # (T, J, 3) euler deg
    root_positions: np.ndarray,  # (T, 3)
    reference: Optional[BvhSkeleton] = None,
    fps: float = 30,
):
    """Write generated gesture rotations onto a (reference) skeleton.

    Mirrors sample/generate.py:246-256: per-joint rotation tracks, joint
    translations pinned to their offsets, root translation from positions.
    """
    t, j, _ = rotations.shape
    sk = reference if reference is not None else make_default_skeleton(j, 1 / fps)
    sk.frames = t
    lj = sk.list_of_joints()
    if len(lj) < j:
        raise ValueError(f"skeleton has {len(lj)} joints, need {j}")
    for k, joint in enumerate(lj[:j]):
        joint.rotation = rotations[:, k, :]
        joint.translation = np.tile(joint.offset, (t, 1))
    sk.root.translation = root_positions
    write_bvh(sk, path, frame_time=1.0 / fps)
