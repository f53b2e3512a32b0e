"""GENEA 2022/2023 speech-to-gesture windowed datasets (host-side numpy).

Copy of gesturediffusion_tpu/data/genea.py for the port: the reference
gesture datasets' on-disk layout, windowing (train step 30, val step =
window), z-normalisation (a zero std counts as 1), TSV word windows and
MFCC features.  Takes are memory-mapped once and windows sliced out.
Genea2023's MFCCs are computed once per take and cached in
``<srcpath>/mfcc_cache/<take>.npy`` (or under ``GDT_MFCC_CACHE``), the
file the JAX package writes and reads, so a cache written by either
package serves both; ``use_mfcc_cache=False`` computes each window's
MFCCs from its exact audio chunk, as the reference does.
"""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np

from gesturediffusion_tpu_torch.ops.mfcc import mfcc as mfcc_fn


def _load_takes(metadata_csv: str, suffix: str = "") -> list[str]:
    with open(metadata_csv) as f:
        rows = [row for row in csv.reader(f, delimiter=",")]
    return [row[0] + suffix for row in rows[1:]]


class Genea2023:
    """Windowed GENEA-2023 dataset (main agent).

    Items: dict(motion [W, D], text str, length W, audio [W*sr/fps],
    mfcc [W, C], seed [S, D]) — z-normalized like the reference.
    """

    def __init__(
        self,
        datapath: str = "./dataset/Genea2023/",
        split: str = "train",
        step: int = 30,
        window: int = 80,
        fps: int = 30,
        sr: int = 22050,
        n_seed_poses: int = 10,
        num_frames: Optional[int] = None,
        use_mfcc_cache: bool = True,
    ):
        if split == "train":
            srcpath = os.path.join(datapath, "trn/main-agent/")
            self.step = step
        elif split == "val":
            srcpath = os.path.join(datapath, "val/main-agent/")
            self.step = window
        else:
            raise NotImplementedError(f"split {split}")

        self.datapath = datapath
        self.srcpath = srcpath
        self.window = window
        self.fps = fps
        self.sr = sr
        self.n_seed_poses = n_seed_poses
        self.use_mfcc_cache = use_mfcc_cache

        trn = os.path.join(datapath, "trn/main-agent/")
        self.std = np.load(os.path.join(trn, "rotpos_Std.npy"))
        self.mean = np.load(os.path.join(trn, "rotpos_Mean.npy"))
        self.mfcc_std = np.load(os.path.join(trn, "mfccs_Std.npy"))
        self.mfcc_mean = np.load(os.path.join(trn, "mfccs_Mean.npy"))
        self.frames = np.load(os.path.join(srcpath, "rotpos_frames.npy"))
        self.std = np.where(self.std == 0, 1.0, self.std)
        self.mfcc_std = np.where(self.mfcc_std == 0, 1.0, self.mfcc_std)

        self.motionpath = os.path.join(srcpath, "motion_npy_rotpos")
        self.audiopath = os.path.join(srcpath, "audio_npy")
        self.textpath = os.path.join(srcpath, "tsv")
        self.mfcc_cache_dir = os.path.join(srcpath, "mfcc_cache")

        # max(0, .): a take shorter than the window contributes no
        # samples — a negative count would make samples_cumulative
        # non-monotonic and silently corrupt the searchsorted mapping
        self.samples_per_file = [
            max(0, int(np.floor((n - self.window) / self.step)))
            for n in self.frames
        ]
        self.samples_cumulative = np.cumsum(self.samples_per_file)
        self.length = int(self.samples_cumulative[-1])

        self.takes = _load_takes(
            os.path.join(srcpath, "../metadata.csv"), "_main-agent"
        )
        for name in self.takes:
            for sub, ext in [
                (self.motionpath, ".npy"),
                (self.audiopath, ".npy"),
                (self.textpath, ".tsv"),
            ]:
                path = os.path.join(sub, name + ext)
                if not os.path.isfile(path):  # survives python -O
                    raise FileNotFoundError(f"missing data file {path}")

        self._motion_mmap: dict[int, np.ndarray] = {}
        self._audio_mmap: dict[int, np.ndarray] = {}
        self._mfcc_cache: dict[int, np.ndarray] = {}
        self._text_cache: dict[int, list] = {}

    # ------------------------------------------------------------------ #
    @property
    def pose_dim(self) -> int:
        return int(self.mean.shape[-1])

    def __len__(self) -> int:
        return self.length

    def _locate(self, idx: int) -> tuple[int, int]:
        file_idx = int(
            np.searchsorted(self.samples_cumulative, idx + 1, side="left")
        )
        sample = idx - (
            int(self.samples_cumulative[file_idx - 1]) if file_idx > 0 else 0
        )
        return file_idx, sample

    def _motion(self, file_idx: int) -> np.ndarray:
        if file_idx not in self._motion_mmap:
            self._motion_mmap[file_idx] = np.load(
                os.path.join(self.motionpath, self.takes[file_idx] + ".npy"),
                mmap_mode="r",
            )
        return self._motion_mmap[file_idx]

    def _audio(self, file_idx: int) -> np.ndarray:
        if file_idx not in self._audio_mmap:
            self._audio_mmap[file_idx] = np.load(
                os.path.join(self.audiopath, self.takes[file_idx] + ".npy"),
                mmap_mode="r",
            )
        return self._audio_mmap[file_idx]

    def _take_mfcc(self, file_idx: int) -> np.ndarray:
        """Full-take MFCCs (frame-aligned), cached to disk + memory.

        Disk writes are atomic (tmp file + rename) because loader threads /
        multiple hosts may race on the same take; read-only dataset mounts
        degrade gracefully to the in-memory cache.  Override the cache root
        with GDT_MFCC_CACHE.
        """
        if file_idx in self._mfcc_cache:
            return self._mfcc_cache[file_idx]
        cache_dir = os.environ.get("GDT_MFCC_CACHE", self.mfcc_cache_dir)
        cache_file = os.path.join(cache_dir, self.takes[file_idx] + ".npy")
        feats = None
        if os.path.isfile(cache_file):
            try:
                feats = np.load(cache_file)
            except (ValueError, EOFError, OSError):
                feats = None  # partial write from a racing process
        if feats is None:
            audio = np.asarray(self._audio(file_idx))
            feats = mfcc_fn(audio, samplerate=self.sr, winstep=1.0 / self.fps)
            feats = feats.astype(np.float32)
            try:
                os.makedirs(cache_dir, exist_ok=True)
                # .npy suffix so np.save doesn't append another
                tmp = cache_file + f".{os.getpid()}.tmp.npy"
                np.save(tmp, feats)
                os.replace(tmp, cache_file)
            except OSError:
                pass  # read-only mount: in-memory cache only
        self._mfcc_cache[file_idx] = feats
        return feats

    def _window_mfcc(self, file_idx: int, sample: int) -> np.ndarray:
        """MFCCs for one window.

        With ``use_mfcc_cache`` (default): slice the take-level cached
        features — window starts are exact hop multiples
        (step*sr/fps = k*hop), so frames align with chunk-computed ones
        except for pre-emphasis/padding edge effects at the chunk
        boundaries.  With the cache off: recompute on the exact audio
        chunk, bit-matching the reference's per-item DSP
        (dataset.py:81-95).
        """
        if self.use_mfcc_cache:
            take_feats = self._take_mfcc(file_idx)
            lo = sample * self.step
            # return short at take end (like the exact path); collate pads
            # AFTER z-normalization, keeping both paths consistent
            return take_feats[lo : lo + self.window]
        audio = np.asarray(self._audio(file_idx))
        i = int(sample * self.sr * self.step / self.fps)
        chunk = audio[i : int(i + self.window * self.sr / self.fps)]
        feats = mfcc_fn(chunk, samplerate=self.sr, winstep=1.0 / self.fps)
        return feats.astype(np.float32)

    def _text_words(self, file_idx: int) -> list:
        if file_idx not in self._text_cache:
            with open(
                os.path.join(self.textpath, self.takes[file_idx] + ".tsv")
            ) as tsv:
                rows = [
                    [float(r[0]) * self.fps, float(r[1]) * self.fps, r[2]]
                    for r in csv.reader(tsv, delimiter="\t")
                ]
            self._text_cache[file_idx] = rows
        return self._text_cache[file_idx]

    @staticmethod
    def _search_time(words: list, frame: float) -> Optional[int]:
        for i in range(len(words)):
            if frame <= words[i][0]:
                return i if (frame > words[i - 1][1] or i == 0) else i - 1
        return None

    def __getitem__(self, idx: int) -> dict:
        file_idx, sample = self._locate(idx)
        motion_file = self._motion(file_idx)
        lo = sample * self.step
        motion = (motion_file[lo : lo + self.window] - self.mean) / self.std
        seed = (motion_file[lo : lo + self.n_seed_poses] - self.mean) / self.std

        audio = np.asarray(self._audio(file_idx))
        i = int(sample * self.sr * self.step / self.fps)
        audio_chunk = audio[i : int(i + self.window * self.sr / self.fps)]
        feats = self._window_mfcc(file_idx, sample)
        feats = (feats - self.mfcc_mean) / self.mfcc_std

        words = self._text_words(file_idx)
        begin = self._search_time(words, lo)
        end = self._search_time(words, lo + self.window)
        text = " ".join(w[-1] for w in words[begin:end]) if begin is not None else ""

        return {
            "motion": motion.astype(np.float32),
            "text": text,
            "length": self.window,
            "audio": audio_chunk.astype(np.float32),
            "mfcc": feats.astype(np.float32),
            "seed": seed.astype(np.float32),
        }

    def inv_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean


class Genea2022:
    """Windowed GENEA-2022 dataset (70/30 sample split, no seed poses)."""

    def __init__(
        self,
        datapath: str = "./dataset/Genea/trn",
        split: str = "train",
        step: int = 30,
        window: int = 200,
        fps: int = 30,
        sr: int = 22050,
        num_frames: Optional[int] = None,
        n_seed_poses: Optional[int] = None,
    ):
        if n_seed_poses:
            raise NotImplementedError("Genea2022 has no seed poses")
        self.datapath = datapath
        self.window = num_frames or window
        self.step = step
        self.fps = fps
        self.sr = sr
        self.motionpath = os.path.join(datapath, "motion_npy")
        self.audiopath = os.path.join(datapath, "audio_npy")
        self.textpath = os.path.join(datapath, "tsv")
        self.std = np.load(os.path.join(datapath, "Std.npy"))
        self.mean = np.load(os.path.join(datapath, "Mean.npy"))
        self.mfcc_std = np.load(os.path.join(datapath, "mfccs_Std.npy"))
        self.mfcc_mean = np.load(os.path.join(datapath, "mfccs_Mean.npy"))
        self.frames = np.load(os.path.join(datapath, "frames.npy"))
        self.std = np.where(self.std == 0, 1.0, self.std)
        self.mfcc_std = np.where(self.mfcc_std == 0, 1.0, self.mfcc_std)

        # max(0, .): a take shorter than the window contributes no
        # samples — a negative count would make samples_cumulative
        # non-monotonic and silently corrupt the searchsorted mapping
        self.samples_per_file = [
            max(0, int(np.floor((n - self.window) / self.step)))
            for n in self.frames
        ]
        self.samples_cumulative = np.cumsum(self.samples_per_file)

        self.takes = []
        with open(os.path.join(datapath, "trn_2022_v1_metadata.csv")) as f:
            self.takes = [row[0] for row in csv.reader(f, delimiter=",")]

        total = int(self.samples_cumulative[-1])
        if split == "train":
            self.begin, self.end = 0, int(total * 0.7)
        elif split == "val":
            self.begin, self.end = int(total * 0.7), total
        else:
            raise NotImplementedError(f"split {split}")
        self.length = self.end - self.begin
        self._motion_mmap: dict[int, np.ndarray] = {}
        self._audio_mmap: dict[int, np.ndarray] = {}
        self._text_cache: dict[int, list] = {}

    def __len__(self) -> int:
        return self.length

    @property
    def pose_dim(self) -> int:
        return int(self.mean.shape[-1])

    def __getitem__(self, idx: int) -> dict:
        idx += self.begin
        file_idx = int(
            np.searchsorted(self.samples_cumulative, idx + 1, side="left")
        )
        sample = idx - (
            int(self.samples_cumulative[file_idx - 1]) if file_idx > 0 else 0
        )
        # each map filled on its own: the loader's threads may reach a take
        # at once, and one must not find the motion mapped and the audio
        # not yet (the JAX package maps both under the motion's test,
        # genea.py:315-323, and its threaded loader can fail there)
        if file_idx not in self._motion_mmap:
            self._motion_mmap[file_idx] = np.load(
                os.path.join(self.motionpath, self.takes[file_idx] + ".npy"),
                mmap_mode="r",
            )
        if file_idx not in self._audio_mmap:
            self._audio_mmap[file_idx] = np.load(
                os.path.join(self.audiopath, self.takes[file_idx] + ".npy"),
                mmap_mode="r",
            )
        motion_file = self._motion_mmap[file_idx]
        lo = sample * self.step
        motion = (motion_file[lo : lo + self.window] - self.mean) / self.std

        audio = np.asarray(self._audio_mmap[file_idx])
        i = int(sample * self.sr * self.step / self.fps)
        chunk = audio[i : int(i + self.window * self.sr / self.fps)]
        feats = mfcc_fn(chunk, samplerate=self.sr, winstep=1.0 / self.fps)
        feats = ((feats - self.mfcc_mean) / self.mfcc_std).astype(np.float32)

        if file_idx not in self._text_cache:
            with open(
                os.path.join(self.textpath, self.takes[file_idx] + ".tsv")
            ) as tsv:
                self._text_cache[file_idx] = [
                    [float(r[0]) * self.fps, float(r[1]) * self.fps, r[2]]
                    for r in csv.reader(tsv, delimiter="\t")
                ]
        words = self._text_cache[file_idx]
        begin = Genea2023._search_time(words, lo)
        end = Genea2023._search_time(words, lo + self.window)
        text = " ".join(w[-1] for w in words[begin:end]) if begin is not None else ""

        return {
            "motion": motion.astype(np.float32),
            "text": text,
            "length": self.window,
            "audio": chunk.astype(np.float32),
            "mfcc": feats,
        }

    def inv_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean
