"""HumanML3D / KIT text-to-motion data, as the edit and predict paths read it.

Copy of the parts of gesturediffusion_tpu/data/humanml.py that motion
editing and text-to-motion sampling use: ``Text2MotionDatasetV2`` (:121;
length-sorted clips, unit-length crops, z-normalisation), ``TextOnlyDataset``
(:427) and ``make_synthetic_humanml`` (:466).  The GloVe / part-of-speech
word vectors of the evaluators (``WordVectorizer``, ``HashVectorizer``,
``MotionDatasetV2``, ``Text2MotionDatasetBaseline``, ``RawTextDataset``)
wait for the evaluation slice.  Items draw from the same
``random.Random(0)`` in the same order as the JAX package's, so both
packages give the same crops.

On-disk layout: <root>/{new_joint_vecs/*.npy, texts/*.txt, Mean.npy,
Std.npy, train.txt / val.txt / test.txt}.
"""

from __future__ import annotations

import os
import random
from os.path import join as pjoin
from typing import Optional

import numpy as np


class Text2MotionDatasetV2:
    """Text-to-motion clips of one split, sorted by length.  An item is
    {"text": caption, "motion": [max_motion_length, D] z-normalised and
    zero-padded, "length": frames kept}."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        dataset_name: str = "t2m",
        max_motion_length: int = 196,
        unit_length: int = 4,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        rng: Optional[random.Random] = None,
    ):
        self.root = root
        self.dataset_name = dataset_name
        self.max_motion_length = max_motion_length
        self.unit_length = unit_length
        self.rng = rng or random.Random(0)
        self.max_length = 20
        self.pointer = 0
        min_motion_len = 40 if dataset_name == "t2m" else 24

        self.mean = mean if mean is not None else np.load(pjoin(root, "Mean.npy"))
        self.std = std if std is not None else np.load(pjoin(root, "Std.npy"))

        motion_dir = pjoin(root, "new_joint_vecs")
        text_dir = pjoin(root, "texts")
        with open(pjoin(root, f"{split}.txt")) as f:
            id_list = [line.strip() for line in f if line.strip()]

        data_dict = {}
        new_name_list, length_list = [], []
        for name in id_list:
            try:
                motion = np.load(pjoin(motion_dir, name + ".npy"))
            except FileNotFoundError:
                continue
            if len(motion) < min_motion_len or len(motion) >= 200:
                continue
            text_data, flag = [], False
            with open(pjoin(text_dir, name + ".txt")) as f:
                for line in f:
                    line_split = line.strip().split("#")
                    if len(line_split) < 4:
                        continue
                    caption = line_split[0]
                    tokens = line_split[1].split(" ")
                    f_tag = float(line_split[2]) if line_split[2] != "nan" else 0.0
                    to_tag = float(line_split[3]) if line_split[3] != "nan" else 0.0
                    text_dict = {"caption": caption, "tokens": tokens}
                    if f_tag == 0.0 and to_tag == 0.0:
                        flag = True
                        text_data.append(text_dict)
                    else:
                        # a caption of a sub-range is a clip of its own
                        n_motion = motion[int(f_tag * 20):int(to_tag * 20)]
                        if len(n_motion) < min_motion_len or len(n_motion) >= 200:
                            continue
                        new_name = self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + name
                        while new_name in data_dict:
                            new_name = self.rng.choice("ABCDEFGHIJKLMNOPQRSTUVW") + "_" + name
                        data_dict[new_name] = {"motion": n_motion, "length": len(n_motion),
                                               "text": [text_dict]}
                        new_name_list.append(new_name)
                        length_list.append(len(n_motion))
            if flag:
                data_dict[name] = {"motion": motion, "length": len(motion), "text": text_data}
                new_name_list.append(name)
                length_list.append(len(motion))

        if not new_name_list:
            raise ValueError(f"no usable motions under {root} ({split})")
        name_list, length_list = zip(
            *sorted(zip(new_name_list, length_list), key=lambda x: x[1]))
        self.length_arr = np.array(length_list)
        self.data_dict = data_dict
        self.name_list = list(name_list)
        self.reset_max_len(self.max_length)

    @property
    def pose_dim(self) -> int:
        return int(self.mean.shape[-1])

    def reset_max_len(self, length: int):
        assert length <= self.max_motion_length
        self.pointer = int(np.searchsorted(self.length_arr, length))
        self.max_length = length

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.data_dict) - self.pointer

    def __getitem__(self, item: int) -> dict:
        data = self.data_dict[self.name_list[self.pointer + item]]
        motion, m_length = data["motion"], data["length"]
        caption = self.rng.choice(data["text"])["caption"]

        # a crop of whole units; with probability 1/3 one unit shorter
        # when units are short (the reference's augmentation, which the
        # evaluators' input distribution depends on)
        n_units = m_length // self.unit_length
        if self.unit_length < 10 and self.rng.random() < 1.0 / 3.0:
            n_units -= 1
        m_length = n_units * self.unit_length
        start = self.rng.randint(0, len(motion) - m_length)
        motion = (motion[start:start + m_length] - self.mean) / self.std
        if m_length < self.max_motion_length:
            motion = np.concatenate(
                [motion, np.zeros((self.max_motion_length - m_length, motion.shape[1]))], axis=0)
        return {"text": caption, "motion": motion.astype(np.float32), "length": int(m_length)}


class TextOnlyDataset:
    """The first caption of each clip of a split, for generation without
    motion capture (humanml.py:TextOnlyDataset)."""

    def __init__(self, root: str, split: str = "test", max_motion_length: int = 196):
        self.max_motion_length = max_motion_length
        self.mean = np.load(pjoin(root, "Mean.npy"))
        self.std = np.load(pjoin(root, "Std.npy"))
        text_dir = pjoin(root, "texts")
        with open(pjoin(root, f"{split}.txt")) as f:
            id_list = [line.strip() for line in f if line.strip()]
        self.captions = []
        for name in id_list:
            try:
                with open(pjoin(text_dir, name + ".txt")) as f:
                    for line in f:
                        cap = line.strip().split("#")[0]
                        if cap:
                            self.captions.append(cap)
                            break
            except FileNotFoundError:
                continue

    def inv_transform(self, data):
        return data * self.std + self.mean

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, item: int) -> dict:
        return {
            "motion": np.zeros((self.max_motion_length, len(self.mean)), np.float32),
            "length": self.max_motion_length,
            "text": self.captions[item],
        }


def make_synthetic_humanml(
    root: str, n_clips: int = 8, dim: int = 263, seed: int = 0,
    splits=("train", "val", "test"),
) -> str:
    """A HumanML3D-layout tree of smooth random features (60-195 frames a
    clip, one caption each) with its Mean / Std and split lists: the same
    bytes as the JAX package's maker for the same arguments."""
    rng = np.random.RandomState(seed)
    os.makedirs(pjoin(root, "new_joint_vecs"), exist_ok=True)
    os.makedirs(pjoin(root, "texts"), exist_ok=True)
    names = []
    for i in range(n_clips):
        name = f"{i:06d}"
        names.append(name)
        t = rng.randint(60, 196)
        motion = np.cumsum(rng.randn(t, dim).astype(np.float32) * 0.05, 0)
        np.save(pjoin(root, "new_joint_vecs", name + ".npy"), motion)
        with open(pjoin(root, "texts", name + ".txt"), "w") as f:
            f.write("a person walks forward and waves#a/DET person/NOUN "
                    "walk/VERB forward/ADV#0.0#0.0\n")
    cat = np.concatenate([np.load(pjoin(root, "new_joint_vecs", n + ".npy")) for n in names])
    np.save(pjoin(root, "Mean.npy"), cat.mean(0))
    np.save(pjoin(root, "Std.npy"), np.where(cat.std(0) == 0, 1, cat.std(0)))
    k = max(1, n_clips // len(splits))
    for si, split in enumerate(splits):
        with open(pjoin(root, f"{split}.txt"), "w") as f:
            chunk = names[si * k:(si + 1) * k] or names[:1]
            f.write("\n".join(chunk) + "\n")
    return root
