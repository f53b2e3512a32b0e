"""UESTC action-to-motion dataset (VIBE-estimated SMPL rotvecs, 40 classes).

Copy of gesturediffusion_tpu/data/uestc.py for the port: the on-disk
layout (info/names.txt, info/num_frames_min.txt, info/action_classes.txt,
vibe_cache_refined.pkl), the 51/67 subject split, the camera-depth
recovery (``vibe_global_translation``), the front-view correction of
side-2 recordings (``yaw_matrix``), the train split's minimum length, and
``make_synthetic_uestc``.  The global-translation cache
``globtrans_usez.pkl`` is the same file the JAX package writes.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np

from gesturediffusion_tpu_torch.data.a2m import A2MDataset
from gesturediffusion_tpu_torch.ops.rotations_np import (
    axis_angle_to_matrix_np,
    matrix_to_axis_angle_np,
)

# action2motion's 18-joint subset of VIBE's 49 regressed joints
ACTION2MOTION_JOINTS = [8, 1, 2, 3, 4, 5, 6, 7, 0, 9, 10, 11, 12, 13, 14,
                        21, 24, 38]

# 51 of the 118 capture subjects train; the rest test
# (spec: data_loaders/a2m/uestc.py:66-73)
TRAIN_SUBJECTS = [
    1, 2, 6, 12, 13, 16, 21, 24, 28, 29, 30, 31, 33, 35, 39, 41, 42, 45,
    47, 50, 52, 54, 55, 57, 59, 61, 63, 64, 67, 69, 70, 71, 73, 77, 81,
    84, 86, 87, 88, 90, 91, 93, 96, 99, 102, 103, 104, 107, 108, 112, 113,
]

_NUM_SUBJECTS = 118
_NUM_ACTIONS = 40
_IMG_SIZE = 540.0
_FOCAL_LENGTH = 500.0


class VideoRecord(NamedTuple):
    """Fields encoded in a UESTC video filename
    `a{action}_d{view}_p{subject:03d}_c{side}_color.avi`."""

    action: int
    view: int
    subject: int
    side: int

    @classmethod
    def from_name(cls, name: str) -> "VideoRecord":
        fields = name.split("_")[:4]
        return cls(*(int(f[1:]) for f in fields))


def vibe_global_translation(orig_cam: np.ndarray,
                            use_depth: bool = True) -> np.ndarray:
    """Per-frame global translation [T, 3] from VIBE's original-image
    weak-perspective camera [T, 4] = [sx, sy, tx, ty], relative to the
    first frame.

    x/y come straight from the camera offsets.  The depth is the
    reference's orthographic-to-perspective fit (spec:
    data_loaders/a2m/uestc.py:14-23): it solves
    ``z = flength * h3d / h2d`` where h2d is the image-space joint
    bounding-diagonal under the weak-perspective projection
    ``(s * (xy + t) + 1) * 0.5 * img``.  That projection is affine in
    xy, so h2d == s * 0.5 * img * h3d and the joints cancel exactly:
    ``z = flength / (0.5 * img * s)``.  We use the closed form (the
    reference computes the same value the long way round through the
    joints, per frame in python).
    """
    cam = np.asarray(orig_cam, np.float64)
    xy = cam[:, 2:4]
    if use_depth:
        z = _FOCAL_LENGTH / (0.5 * _IMG_SIZE * cam[:, 0:1])
    else:
        z = np.zeros((cam.shape[0], 1))
    trans = np.concatenate([xy, z], axis=1)
    return trans - trans[0]


def yaw_matrix(view: int) -> np.ndarray:
    """Rotation undoing camera view `view` (views sit every 45 deg around
    +y; spec: data_loaders/a2m/uestc.py:122-130)."""
    theta = -view * np.pi / 4
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


class UESTC(A2MDataset):
    dataname = "uestc"

    def __init__(self, datapath="dataset/uestc", method_name="vibe",
                 view="all", **kwargs):
        self.datapath = datapath
        self.method_name = method_name
        self.view = view
        super().__init__(**kwargs)
        if method_name != "vibe":
            raise ValueError(
                f"UESTC supports only VIBE-estimated poses, got "
                f"method_name={method_name!r}"
            )

        self._videos = self._read_info_lines("names.txt")
        frame_counts = np.asarray(
            [int(s) for s in self._read_info_lines("num_frames_min.txt")]
        )
        self._action_classes = np.array(
            self._read_info_lines("action_classes.txt")
        )
        self.records = [VideoRecord.from_name(v) for v in self._videos]
        self.video_info = [r._asdict() for r in self.records]
        self._actions = [r.action for r in self.records]

        self.num_actions = self.num_classes = _NUM_ACTIONS
        self._action_to_label = {a: a for a in range(_NUM_ACTIONS)}
        self._label_to_action = {a: a for a in range(_NUM_ACTIONS)}
        self._train_subjects = TRAIN_SUBJECTS
        self._test_subjects = sorted(
            set(range(1, _NUM_SUBJECTS + 1)) - set(TRAIN_SUBJECTS)
        )

        self._load_vibe_cache()
        self._jointsIx = ACTION2MOTION_JOINTS
        frame_counts = np.minimum(
            frame_counts, [p.shape[0] for p in self._pose]
        ).astype(int)
        self._num_frames_in_video = list(frame_counts)

        self._train, self._test = self._correct_views_and_split()

        # keep only train sequences long enough for the window
        # (spec: data_loaders/a2m/uestc.py:168-176 — test kept untouched)
        min_ok = self.num_frames * 3 / 4 if self.num_frames > 0 else 0
        long_enough = set(np.flatnonzero(frame_counts >= min_ok).tolist())
        self._train = list(set(self._train) & long_enough)
        self._test = list(set(self._test))

    # -------------------------------------------------------------- #
    def _read_info_lines(self, fname: str) -> list[str]:
        with open(os.path.join(self.datapath, "info", fname)) as f:
            return f.read().splitlines()

    def _load_vibe_cache(self) -> None:
        with open(os.path.join(self.datapath, "vibe_cache_refined.pkl"),
                  "rb") as f:
            vibe = pickle.load(f)
        self._pose = vibe["pose"]
        self._joints = vibe["joints3d"]
        cache = os.path.join(self.datapath, "globtrans_usez.pkl")
        self._globtrans = None
        if os.path.exists(cache):
            try:
                with open(cache, "rb") as f:
                    self._globtrans = pickle.load(f)
            except (EOFError, pickle.UnpicklingError, OSError):
                self._globtrans = None  # partial write from a racer
        if self._globtrans is None:
            self._globtrans = [
                vibe_global_translation(cam) for cam in vibe["orig_cam"]
            ]
            try:
                # atomic publish (tmp + rename) so concurrent processes
                # never read a truncated pickle; read-only mounts skip
                # the cache (same defence as the genea MFCC cache)
                tmp = cache + f".{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(self._globtrans, f)
                os.replace(tmp, cache)
            except OSError:
                pass

    def _correct_views_and_split(self) -> tuple[list[int], list[int]]:
        """Rotate side-2 recordings to the front view (in place, on the
        shared pose/joints/globtrans payload), translate joints into
        global space, and bucket each video by its subject's split."""
        train, test = [], []
        train_subjects = set(self._train_subjects)
        for index, rec in enumerate(self.records):
            if rec.side != 1:
                if self.view == "frontview" or rec.view == 8:
                    continue
                self._rotate_to_front(index, rec.view)
            self._joints[index] = (
                self._joints[index] + self._globtrans[index][:, None]
            )
            if rec.subject in train_subjects:
                train.append(index)
            elif 1 <= rec.subject <= _NUM_SUBJECTS:
                test.append(index)
            else:
                raise ValueError(
                    f"video {self._videos[index]!r}: subject "
                    f"{rec.subject} outside the 1..{_NUM_SUBJECTS} range"
                )
        return train, test

    def _rotate_to_front(self, index: int, view: int) -> None:
        rot = yaw_matrix(view)
        root_mats = axis_angle_to_matrix_np(self._pose[index][:, :3])
        self._pose[index][:, :3] = matrix_to_axis_angle_np(rot @ root_mats)
        self._joints[index] = self._joints[index] @ rot.T
        self._globtrans[index] = self._globtrans[index] @ rot.T

    # -------------------------------------------------------------- #
    def _load_joints3D(self, ind, frame_ix):
        joints = self._joints[ind]
        if len(joints) == 0:
            raise ValueError(
                f"UESTC video index {ind} has no VIBE joints3d frames"
            )
        return joints[frame_ix][:, self._jointsIx]

    def _load_rotvec(self, ind, frame_ix):
        return self._pose[ind][frame_ix, :].reshape(-1, 24, 3)

    def parse_action(self, path, return_int=True):
        action = VideoRecord.from_name(path).action
        return int(action) if return_int else action


def make_synthetic_uestc(
    root: str,
    n_videos: int = 16,
    n_actions: int = 4,
    seed: int = 0,
    min_frames: int = 64,
    max_frames: int = 80,
) -> str:
    """Synthetic vibe_cache_refined.pkl-shaped UESTC fixture for hermetic
    tests (covers train/test subjects, side-2 view correction, all views).

    Layout mirrors what the real dataset directory provides
    (spec: data_loaders/a2m/uestc.py:59-96 — info/num_frames_min.txt,
    info/names.txt, info/action_classes.txt, vibe_cache_refined.pkl with
    pose [T,72] / joints3d [T,49,3] / orig_cam [T,4] lists).
    """
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "info"), exist_ok=True)
    names, nframes, poses, joints, cams = [], [], [], [], []
    # subjects 1/2 are in TRAIN_SUBJECTS; 3/4 fall into the test split
    subjects = [1, 2, 3, 4]
    for v in range(n_videos):
        act = v % n_actions
        view = v % 8
        subject = subjects[v % len(subjects)]
        side = 1 if v % 2 == 0 else 2
        names.append(f"a{act}_d{view}_p{subject:03d}_c{side}_color.avi")
        t = int(rng.randint(min_frames, max_frames + 1))
        nframes.append(t)
        poses.append(
            np.cumsum(rng.randn(t, 72).astype(np.float32) * 0.02, axis=0)
        )
        joints.append(
            np.cumsum(rng.randn(t, 49, 3).astype(np.float32) * 0.01, axis=0)
        )
        cams.append(
            np.concatenate(
                [
                    rng.uniform(0.8, 1.2, (t, 2)),
                    rng.uniform(-0.1, 0.1, (t, 2)),
                ],
                axis=1,
            ).astype(np.float32)
        )
    with open(os.path.join(root, "info", "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "info", "num_frames_min.txt"), "w") as f:
        f.write("\n".join(str(n) for n in nframes) + "\n")
    with open(os.path.join(root, "info", "action_classes.txt"), "w") as f:
        f.write("\n".join(f"action_{i}" for i in range(40)) + "\n")
    with open(os.path.join(root, "vibe_cache_refined.pkl"), "wb") as f:
        pickle.dump(
            {"pose": poses, "joints3d": joints, "orig_cam": cams}, f
        )
    return root
