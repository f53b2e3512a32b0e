"""Action-to-motion datasets: HumanAct12 (and the base of UESTC).

Copy of gesturediffusion_tpu/data/a2m.py for the port: ``A2MDataset``
with the pose-representation dispatch (``_load``) and the frame sampling
(``_sample_frames``) on a ``random.Random``, drawn in the JAX package's
order so that a seed gives the same items; ``A2MSplitView``;
``HumanAct12Poses`` (the pickle of poses, joints3D and 12 labels);
``make_synthetic_humanact12``; and ``collate_a2m``.  Host-side numpy
throughout, the rotations through ops/rotations_np.py.  An item is
{"motion": [T, J*F], "pose": [J(+1), F, T], "action": int, "length": T,
"action_text": str}.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Optional, Sequence

import numpy as np

from gesturediffusion_tpu_torch.ops.rotations_np import (
    axis_angle_to_matrix_np,
    axis_angle_to_quaternion_np,
    matrix_to_rotation_6d_np,
)

HUMANACT12_ACTIONS = {
    0: "warm_up", 1: "walk", 2: "run", 3: "jump", 4: "drink",
    5: "lift_dumbbell", 6: "sit", 7: "eat", 8: "turn steering wheel",
    9: "phone", 10: "boxing", 11: "throw",
}


class A2MDataset:
    """Base action-to-motion dataset (subclasses set _pose/_joints/_actions)."""

    dataname = "a2m"

    def __init__(
        self,
        num_frames: int = 60,
        sampling: str = "conseq",
        sampling_step: int = 1,
        split: str = "train",
        pose_rep: str = "rot6d",
        translation: bool = True,
        glob: bool = True,
        max_len: int = -1,
        min_len: int = -1,
        num_seq_max: int = -1,
        rng: Optional[random.Random] = None,
        **kwargs,
    ):
        if split not in ("train", "val", "test"):
            raise ValueError(f"{split} is not a valid split")
        self.num_frames = num_frames
        self.sampling = sampling
        self.sampling_step = sampling_step
        self.split = split
        self.pose_rep = pose_rep
        self.translation = translation
        self.glob = glob
        self.max_len = max_len
        self.min_len = min_len
        self.num_seq_max = num_seq_max
        self.rng = rng or random.Random(0)
        self._original_train = None
        self._original_test = None

    # -------------------------------------------------------------- #
    # label plumbing
    # -------------------------------------------------------------- #
    def action_to_label(self, action):
        return self._action_to_label[action]

    def label_to_action(self, label):
        import numbers

        if isinstance(label, numbers.Integral):
            return self._label_to_action[int(label)]
        return self._label_to_action[int(np.argmax(label))]

    def action_to_action_name(self, action):
        return self._action_classes[action]

    def action_name_to_action(self, action_names: Sequence[str]):
        all_names = self._action_classes
        if isinstance(all_names, dict):
            all_names = list(all_names.values())
        sorter = np.argsort(all_names)
        return sorter[np.searchsorted(all_names, action_names, sorter=sorter)]

    # -------------------------------------------------------------- #
    # pose loading
    # -------------------------------------------------------------- #
    def _load(self, ind: int, frame_ix) -> np.ndarray:
        pose_rep = self.pose_rep
        ret_tr = None
        if pose_rep == "xyz" or self.translation:
            joints3d = self._load_joints3D(ind, frame_ix)
            joints3d = joints3d - joints3d[0, 0, :]
            ret = joints3d
            if self.translation:
                ret_tr = joints3d[:, 0, :]
        if pose_rep != "xyz":
            pose = self._load_rotvec(ind, frame_ix)
            if not self.glob:
                pose = pose[:, 1:, :]
            if pose_rep == "rotvec":
                ret = pose
            elif pose_rep == "rotmat":
                ret = axis_angle_to_matrix_np(pose).reshape(
                    pose.shape[:2] + (9,)
                )
            elif pose_rep == "rotquat":
                ret = axis_angle_to_quaternion_np(pose)
            elif pose_rep == "rot6d":
                ret = matrix_to_rotation_6d_np(axis_angle_to_matrix_np(pose))
            else:
                raise ValueError(f"unknown pose_rep {pose_rep}")
        if pose_rep != "xyz" and self.translation:
            padded_tr = np.zeros((ret.shape[0], ret.shape[2]), ret.dtype)
            padded_tr[:, :3] = ret_tr
            ret = np.concatenate([ret, padded_tr[:, None]], axis=1)
        # [T, J, F] -> [J, F, T]
        return np.ascontiguousarray(ret.transpose(1, 2, 0)).astype(np.float32)

    def _sample_frames(self, data_index: int) -> np.ndarray:
        nframes = self._num_frames_in_video[data_index]
        if self.num_frames == -1 and (
            self.max_len == -1 or nframes <= self.max_len
        ):
            return np.arange(nframes)

        if self.num_frames == -2:
            if self.min_len <= 0:
                raise ValueError("num_frames == -2 requires min_len > 0")
            max_frame = (
                min(nframes, self.max_len) if self.max_len != -1 else nframes
            )
            num_frames = self.rng.randint(
                self.min_len, max(max_frame, self.min_len)
            )
        else:
            num_frames = (
                self.num_frames if self.num_frames != -1 else self.max_len
            )

        if num_frames > nframes:
            ntoadd = max(0, num_frames - nframes)
            padding = (nframes - 1) * np.ones(ntoadd, dtype=int)
            return np.concatenate([np.arange(nframes), padding])

        if self.sampling in ("conseq", "random_conseq"):
            step_max = (nframes - 1) // (num_frames - 1)
            if self.sampling == "conseq":
                if (
                    self.sampling_step == -1
                    or self.sampling_step * (num_frames - 1) >= nframes
                ):
                    step = step_max
                else:
                    step = self.sampling_step
            else:
                step = self.rng.randint(1, step_max)
            lastone = step * (num_frames - 1)
            shift_max = nframes - lastone - 1
            shift = self.rng.randint(0, max(0, shift_max - 1))
            return shift + np.arange(0, lastone + 1, step)

        if self.sampling == "random":
            return np.sort(
                np.asarray(
                    self.rng.sample(range(nframes), num_frames), dtype=int
                )
            )
        raise ValueError(
            f"unknown frame-sampling mode {self.sampling!r} "
            "(expected conseq / random_conseq / random)"
        )

    # -------------------------------------------------------------- #
    def _item_for_data_index(self, data_index: int) -> dict:
        """Materialize one item given a raw video/clip index (shared by
        __getitem__ and A2MSplitView)."""
        frame_ix = self._sample_frames(data_index)
        motion = self._load(data_index, frame_ix)
        action = self.action_to_label(self._actions[data_index])
        return {
            "motion": motion.reshape(-1, motion.shape[-1]).T,  # [T, J*F]
            "pose": motion,  # [J, F, T] canonical a2m layout
            "action": int(action),
            "length": motion.shape[-1],
            "action_text": self.action_to_action_name(
                self._actions[data_index]
            ),
        }

    def __getitem__(self, index: int) -> dict:
        indices = self._train if self.split == "train" else self._test
        return self._item_for_data_index(indices[index])

    def __len__(self) -> int:
        num_seq_max = self.num_seq_max if self.num_seq_max != -1 else np.inf
        idx = self._train if self.split == "train" else self._test
        return int(min(len(idx), num_seq_max))

    def shuffle(self):
        idx = self._train if self.split == "train" else self._test
        self.rng.shuffle(idx)

    def reset_shuffle(self):
        if self.split == "train":
            if self._original_train is None:
                self._original_train = list(self._train)
            else:
                self._train = list(self._original_train)
        else:
            if self._original_test is None:
                self._original_test = list(self._test)
            else:
                self._test = list(self._original_test)


class A2MSplitView:
    """An explicit per-split view over an A2MDataset: owns its index
    order and shuffle state, shares the (read-only) motion payload.
    Replaces shallow-copy split surgery — a new mutable field on the
    dataset can never silently leak across split views."""

    def __init__(self, dataset: A2MDataset, split: str,
                 seed: Optional[int] = None):
        if split not in ("train", "test"):
            raise ValueError(f"{split} is not a valid split view")
        self.dataset = dataset
        self.split = split
        base = dataset._train if split == "train" else dataset._test
        self._original = list(base)
        self._indices = list(base)
        self.rng = random.Random(0 if seed is None else seed)

    def __len__(self) -> int:
        limit = self.dataset.num_seq_max
        if limit == -1:
            return len(self._indices)
        return min(len(self._indices), limit)

    def __getitem__(self, index: int) -> dict:
        return self.dataset._item_for_data_index(self._indices[index])

    def shuffle(self) -> None:
        self.rng.shuffle(self._indices)

    def reset_shuffle(self) -> None:
        self._indices = list(self._original)


class HumanAct12Poses(A2MDataset):
    """HumanAct12 pkl loader (poses + joints3D + 12 labels)."""

    dataname = "humanact12"

    def __init__(self, datapath="dataset/HumanAct12Poses", split="train",
                 **kwargs):
        super().__init__(split=split, **kwargs)
        self.datapath = datapath
        with open(os.path.join(datapath, "humanact12poses.pkl"), "rb") as f:
            data = pickle.load(f)
        self._pose = list(data["poses"])
        self._num_frames_in_video = [p.shape[0] for p in self._pose]
        self._joints = list(data["joints3D"])
        self._actions = list(data["y"])
        self.num_actions = 12
        self._train = list(range(len(self._pose)))
        self._test = list(range(len(self._pose)))
        keep = np.arange(12)
        self._action_to_label = {int(x): i for i, x in enumerate(keep)}
        self._label_to_action = {i: int(x) for i, x in enumerate(keep)}
        self._action_classes = HUMANACT12_ACTIONS

    def _load_joints3D(self, ind, frame_ix):
        return self._joints[ind][frame_ix]

    def _load_rotvec(self, ind, frame_ix):
        return self._pose[ind][frame_ix].reshape(-1, 24, 3)


def make_synthetic_humanact12(
    root: str, n_clips: int = 24, seed: int = 0
) -> str:
    """Synthetic HumanAct12-layout pkl (random smooth poses/joints)."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    poses, joints, ys = [], [], []
    for i in range(n_clips):
        t = rng.randint(40, 120)
        poses.append(
            np.cumsum(rng.randn(t, 72).astype(np.float32) * 0.02, axis=0)
        )
        joints.append(
            np.cumsum(rng.randn(t, 24, 3).astype(np.float32) * 0.01, axis=0)
        )
        ys.append(i % 12)
    with open(os.path.join(root, "humanact12poses.pkl"), "wb") as f:
        pickle.dump({"poses": poses, "joints3D": joints, "y": ys}, f)
    return root


def collate_a2m(items: Sequence[dict], max_frames: Optional[int] = None):
    """Collate a2m items -> (motion [B, J, F, T], cond) canonical contract."""
    b = len(items)
    j, f, _ = items[0]["pose"].shape
    t = max_frames or max(it["pose"].shape[-1] for it in items)
    motion = np.zeros((b, j, f, t), np.float32)
    lengths = np.zeros((b,), np.int32)
    actions = np.zeros((b,), np.int32)
    for i, it in enumerate(items):
        ti = min(it["pose"].shape[-1], t)
        motion[i, :, :, :ti] = it["pose"][:, :, :ti]
        lengths[i] = ti
        actions[i] = it["action"]
    mask = (np.arange(t)[None] < lengths[:, None])[:, None, None, :]
    cond = {
        "mask": mask,
        "lengths": lengths,
        "action": actions,
        "action_text": [it["action_text"] for it in items],
    }
    return motion, cond
