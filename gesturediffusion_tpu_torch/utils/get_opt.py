"""The T2M evaluators' ``opt.txt`` reader.

Copy of gesturediffusion_tpu/utils/get_opt.py (:17, the reference's
data_loaders/humanml/utils/get_opt.py): the ``key: value`` lines of an
``opt.txt`` shipped beside a T2M evaluator checkpoint into a namespace
(booleans, ints and floats typed), then the dataset's table (t2m: 22 joints,
263 features; kit: 21 joints, 251 features; both 196 frames at most) and
the paths beside the file.
"""

from __future__ import annotations

import os
from argparse import Namespace
from os.path import join as pjoin

# dataset_name -> (data root, joints, features a frame)
DATASETS = {"t2m": ("./dataset/HumanML3D", 22, 263), "kit": ("./dataset/KIT-ML", 21, 251)}
SKIP = ("-------------- End ----------------", "------------ Options -------------")


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def get_opt(opt_path: str, device=None) -> Namespace:
    opt = Namespace()
    opt_dict = vars(opt)
    with open(opt_path) as f:
        for line in f:
            if line.strip() in SKIP or ":" not in line:
                continue
            key, value = line.strip().split(": ", 1)
            value = value.strip()
            if value in ("True", "False"):
                opt_dict[key] = value == "True"
            elif _is_float(value):
                opt_dict[key] = int(value) if value.lstrip("-").isdigit() else float(value)
            else:
                opt_dict[key] = value

    opt.which_epoch = "finest"
    opt.save_root = os.path.dirname(opt_path)
    opt.model_dir = pjoin(opt.save_root, "model")
    opt.meta_dir = pjoin(opt.save_root, "meta")

    dataset_name = getattr(opt, "dataset_name", "t2m")
    if dataset_name not in DATASETS:
        raise KeyError(f"Dataset not recognized: {dataset_name}")
    opt.data_root, opt.joints_num, opt.dim_pose = DATASETS[dataset_name]
    opt.motion_dir = pjoin(opt.data_root, "new_joint_vecs")
    opt.text_dir = pjoin(opt.data_root, "texts")
    opt.max_motion_length = 196
    opt.dim_word = 300
    opt.num_classes = 200 // getattr(opt, "unit_length", 4)
    opt.dim_pos_ohot = 15
    opt.is_train = False
    opt.is_continue = False
    opt.device = device
    return opt
