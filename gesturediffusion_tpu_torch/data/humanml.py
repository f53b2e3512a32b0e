"""HumanML3D / KIT text-to-motion data, as the edit, predict, train and
text-benchmark paths read it.

Copy of the parts of gesturediffusion_tpu/data/humanml.py that motion
editing, text-to-motion sampling and training and the text benchmark use:
``POS_ENUMERATOR`` and ``VIP_DICT`` (:27, :33), ``WordVectorizer`` (:53; the
released GloVe files ``{prefix}_words.pkl``, ``_idx.pkl``, ``_data.npy``),
``HashVectorizer`` (:94; its md5-seeded stand-in), ``Text2MotionDatasetV2``
(:121; length-sorted clips, unit-length crops, z-normalisation, and with a
``w_vectorizer`` the evaluators' word vectors, part-of-speech one-hots and
sentence length), ``TextOnlyDataset`` (:427) and ``make_synthetic_humanml``
(:466).  ``MotionDatasetV2``, ``Text2MotionDatasetBaseline`` and
``RawTextDataset`` serve the evaluator retraining and the CompV6 baseline,
which are not ported.  Items draw from the same ``random.Random(0)`` in the
same order as the JAX package's, so both packages give the same crops.

On-disk layout: <root>/{new_joint_vecs/*.npy, texts/*.txt, Mean.npy,
Std.npy, train.txt / val.txt / test.txt}.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
from os.path import join as pjoin
from typing import Optional

import numpy as np

# the evaluators' 15 part-of-speech classes (the reference's word_vectorizer.py)
POS_ENUMERATOR = {
    "VERB": 0, "NOUN": 1, "DET": 2, "ADP": 3, "NUM": 4, "AUX": 5,
    "PRON": 6, "ADJ": 7, "ADV": 8, "Loc_VIP": 9, "Body_VIP": 10,
    "Obj_VIP": 11, "Act_VIP": 12, "Desc_VIP": 13, "OTHER": 14,
}

# words whose class the vectorizer takes from this table, not from the tagger
VIP_DICT = {
    "Loc_VIP": ("left", "right", "clockwise", "counterclockwise",
                "anticlockwise", "forward", "back", "backward", "up",
                "down", "straight", "curve"),
    "Body_VIP": ("arm", "chin", "foot", "feet", "face", "hand", "mouth",
                 "leg", "waist", "eye", "knee", "shoulder", "thigh"),
    "Obj_VIP": ("stair", "dumbbell", "chair", "window", "floor", "car",
                "ball", "handrail", "baseball", "basketball"),
    "Act_VIP": ("walk", "run", "swing", "pick", "bring", "kick", "put",
                "squat", "throw", "hop", "dance", "jump", "turn",
                "stumble", "dance", "stop", "sit", "lift", "lower",
                "raise", "wash", "stand", "kneel", "stroll", "rub",
                "bend", "balance", "flap", "jog", "shuffle", "lean",
                "rotate", "spin", "spread", "climb"),
    "Desc_VIP": ("slowly", "carefully", "fast", "careful", "slow",
                 "quickly", "happy", "angry", "sad", "happily",
                 "angrily", "sadly"),
}


def _pos_one_hot(pos: str) -> np.ndarray:
    vec = np.zeros(len(POS_ENUMERATOR))
    vec[POS_ENUMERATOR.get(pos, POS_ENUMERATOR["OTHER"])] = 1
    return vec


class WordVectorizer:
    """GloVe vectors and the 15-way part-of-speech one-hot of a "word/POS"
    token, from the released files under ``meta_root``:
    ``{prefix}_words.pkl`` (the words), ``{prefix}_idx.pkl`` (word -> row)
    and ``{prefix}_data.npy`` (the vectors).  An unknown word takes the
    "unk" vector (zeros without one) and the class OTHER."""

    def __init__(self, meta_root: str, prefix: str):
        with open(pjoin(meta_root, f"{prefix}_words.pkl"), "rb") as f:
            words = pickle.load(f)
        with open(pjoin(meta_root, f"{prefix}_idx.pkl"), "rb") as f:
            word2idx = pickle.load(f)
        vectors = np.load(pjoin(meta_root, f"{prefix}_data.npy"))
        self.word2vec = {w: vectors[word2idx[w]] for w in words}

    def __len__(self):
        return len(self.word2vec)

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        if word not in self.word2vec:
            return self.word2vec.get("unk", np.zeros(300)), _pos_one_hot("OTHER")
        vip = next((key for key, words in VIP_DICT.items() if word in words), None)
        return self.word2vec[word], _pos_one_hot(vip or pos)


class HashVectorizer:
    """The GloVe-free stand-in: a vector of 300 normals x 0.1 from
    ``np.random.RandomState`` seeded by the word's md5 (the same in every
    process, unlike ``hash()``), and the token's own class; not the
    reference's numbers."""

    def __getitem__(self, item: str):
        word, pos = item.split("/")
        seed = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        word_vec = np.random.RandomState(seed).randn(300).astype(np.float32) * 0.1
        return word_vec, _pos_one_hot(pos).astype(np.float32)


def load_word_vectorizer(log):
    """The GloVe vectorizer where its files are (``./glove/our_vab_*``),
    else (logged) the hash stand-in, as the JAX benchmark picks them."""
    try:
        return WordVectorizer("./glove", "our_vab")
    except OSError:
        log("GloVe assets not found — using hash vectorizer (NOT metric-parity)")
        return HashVectorizer()


class Text2MotionDatasetV2:
    """Text-to-motion clips of one split, sorted by length.  An item is
    {"text": caption, "motion": [max_motion_length, D] z-normalised and
    zero-padded, "length": frames kept}; with a ``w_vectorizer`` also the
    caption's tokens between sos and eos, cut to ``max_text_len`` and
    padded with unk to ``max_text_len + 2``: "word_embeddings" [L, 300],
    "pos_one_hots" [L, 15], "sent_len" (sos and eos counted) and
    "tokens"."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        *,
        dataset_name: str = "t2m",
        max_motion_length: int = 196,
        unit_length: int = 4,
        max_text_len: int = 20,
        mean: Optional[np.ndarray] = None,
        std: Optional[np.ndarray] = None,
        w_vectorizer=None,
        rng: Optional[random.Random] = None,
    ):
        self.root = root
        self.dataset_name = dataset_name
        self.max_motion_length = max_motion_length
        self.unit_length = unit_length
        self.max_text_len = max_text_len
        self.w_vectorizer = w_vectorizer
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
        text = self.rng.choice(data["text"])
        out: dict = {"text": text["caption"]}
        if self.w_vectorizer is not None:
            out.update(self._word_vectors(text["tokens"]))

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
        out["motion"] = motion.astype(np.float32)
        out["length"] = int(m_length)
        return out

    def _word_vectors(self, tokens: list) -> dict:
        tokens = ["sos/OTHER", *tokens[:self.max_text_len], "eos/OTHER"]
        sent_len = len(tokens)
        tokens += ["unk/OTHER"] * (self.max_text_len + 2 - sent_len)
        embs, ohs = zip(*(self.w_vectorizer[t] for t in tokens))
        return {"word_embeddings": np.stack(embs).astype(np.float32),
                "pos_one_hots": np.stack(ohs).astype(np.float32), "sent_len": sent_len,
                "tokens": "_".join(tokens)}


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
